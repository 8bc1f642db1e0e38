"""The port's vision modules against the JAX reference, on the CPU at the
small test profile (tests/test_pipeline.py::small_cfg: 320 x 96 images,
256 keypoints, 24 px ZNCC patches). Inputs are rendered by the synthetic
scene from fixed seeds and uint8-quantized as the engines do.

- config: every field of the port's VisualOdometryConfig, detach_VO_LO and
  reference_exact() equals the JAX package's.
- synthetic camera: render_camera, default_cam_calib and the hit ids of
  _ray_scene_range are bit-identical to the JAX package's numpy.
- rotate_axis_angle to 1e-6 (both branches of its coefficients); the numpy
  pose helpers of unpack_vloam_outputs exactly.
- detect_keypoints: mask identical; xy identical with integer corners. With
  subpixel refinement xy to 1e-5 px: the response agrees to the last bit on
  >99% of pixels (XLA fuses some multiply-adds), so a refined offset can
  move by an ulp.
- ZNCC: the plain version (what K3 computes) against the Pallas kernel in
  interpret mode on every row, at 1e-5, p in {16, 24}; against the XLA form
  on the detected keypoints, at 1e-5. The two JAX forms differ where the
  port follows the Pallas kernel: (a) the 1e-3 floor on the centred norm
  (a near-constant patch gives a zero row; the XLA form normalizes its
  noise to unit length), shown on crafted patches; (b) masked keypoints
  parked at (0, 0), whose patch the XLA form's vmapped slice on the CPU
  clamps to the far corner of the image (a negative start clips to the
  maximum) while the Pallas kernel and the port clip to (0, 0). The matcher
  masks those rows either way. The plain version against the Pallas kernel
  also on the crafted K3 cases of vloam_tpu_torch/tools/kernel_cases.py.
- match_descriptors on JAX's descriptors: idx and valid identical, knn and
  nn.
- build_depth_grid: cnt, u, v and z exact (each cell's points add in
  point order, as XLA's CPU scatter adds them; bucket coordinates scale by
  float32 1 / g, as XLA computes the reference's / g); its per-cell sum
  equals a sequential numpy sum in point order bit for bit on values whose
  sum depends on the order; query_depth to 1e-5 with the -1 pattern exact.
- the closed-form VO Jacobian against float64 torch.func.jacfwd, to 2e-5 of
  its scale; solve_vo on the same matches and grid to 1e-4 (the reference
  factors the LM step by Cholesky, the port by LU; the sums add in another
  order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.data import synthetic as jsyn
from vloam_tpu.vision import depth_map as jdm
from vloam_tpu.vision import features as jf
from vloam_tpu.vision import vo as jvo
from vloam_tpu_torch.data import synthetic as tsyn
from vloam_tpu_torch.geometry import so3 as tso3
from vloam_tpu_torch.tools import kernel_cases
from vloam_tpu_torch.vision import depth_map as tdm
from vloam_tpu_torch.vision import features as tf
from vloam_tpu_torch.vision import vo as tvo

from test_pipeline import small_cfg

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# OpenMP pool stalls each small parallel CPU op when they are
# oversubscribed.
torch.set_num_threads(1)

VO = small_cfg().vo
W, H = VO.img_width, VO.img_height


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def frames():
    """Two consecutive frames of a drive: uint8-quantized float images,
    velodyne scans and the velo -> image projection."""
    scene = jsyn.urban_scene(2)
    K, P_rect0, _, velo_T_cam = jsyn.default_cam_calib(W, H)
    poses = jsyn.drive_trajectory(2, speed=1.0, yaw_rate=0.015)
    imgs, scans = [], []
    for k, T in enumerate(poses):
        img = jsyn.render_camera(scene, T @ velo_T_cam, K, W, H)
        u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        imgs.append(u8.astype(np.float32) / np.float32(255.0))
        scans.append(jsyn.simulate_scan(scene, T, n_scans=64, n_azimuth=700,
                                        seed=k))
    P = (P_rect0 @ np.linalg.inv(velo_T_cam)).astype(np.float32)
    return imgs, scans, K.astype(np.float32), P


@pytest.fixture(scope="module")
def jax_vision(frames):
    """JAX keypoints, descriptors, matches and frame 0's depth grid."""
    imgs, scans, _, P = frames
    kps = [jf.detect_keypoints(jnp.asarray(im), VO) for im in imgs]
    descs = [jf.describe_keypoints(jnp.asarray(im), kp[0], VO)
             for im, kp in zip(imgs, kps)]
    grid = jdm.build_depth_grid(jnp.asarray(scans[0]),
                                jnp.ones(len(scans[0]), bool),
                                jnp.asarray(P), VO)
    return ([tuple(map(np.asarray, kp)) for kp in kps],
            [np.asarray(d) for d in descs], grid)


@pytest.mark.parametrize("profile", ["kitti_hdl64", "tiny_test_profile",
                                     "reference_exact"])
def test_port_vo_config_equals_jax_config(profile):
    from vloam_tpu import config as jcfg
    from vloam_tpu_torch import config as tcfg

    want, got = getattr(jcfg, profile)(), getattr(tcfg, profile)()
    assert got.detach_VO_LO == want.detach_VO_LO
    for section in ("lidar", "scanreg", "lo", "mapping", "vo"):
        g, w = getattr(got, section), getattr(want, section)
        for f in dataclasses.fields(g):
            assert getattr(g, f.name) == getattr(w, f.name), (section, f.name)
    assert {f.name for f in dataclasses.fields(got.vo)} == {
        f.name for f in dataclasses.fields(want.vo)}
    flipped = got.replace(detach_VO_LO=False)
    assert not flipped.detach_VO_LO and flipped.vo == got.vo


def test_port_camera_renderer_equals_jax():
    for seed, tex in ((2, 1.0), (5, 0.06)):
        sj = dataclasses.replace(jsyn.urban_scene(seed), tex_scale=tex)
        st = dataclasses.replace(tsyn.urban_scene(seed), tex_scale=tex)
        for w, h in ((320, 96), (124, 38)):
            cj = jsyn.default_cam_calib(w, h)
            ct = tsyn.default_cam_calib(w, h)
            for a, b in zip(ct, cj):
                np.testing.assert_array_equal(a, b)
            T = jsyn.drive_trajectory(3, speed=1.1, yaw_rate=0.02)[2]
            np.testing.assert_array_equal(
                tsyn.render_camera(st, T @ ct[3], ct[0], w, h),
                jsyn.render_camera(sj, T @ cj[3], cj[0], w, h))
        d = np.random.default_rng(seed).normal(size=(500, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o = np.zeros((500, 3))
        for a, b in zip(tsyn._ray_scene_range(o, d, st, with_ids=True),
                        jsyn._ray_scene_range(o, d, sj, with_ids=True)):
            np.testing.assert_array_equal(a, b)


def test_rotate_axis_angle_matches_jax(rng):
    from vloam_tpu.geometry import so3 as jso3

    aa = np.concatenate([rng.normal(0, 1.0, (48, 3)),
                         rng.normal(0, 1e-5, (16, 3))]).astype(np.float32)
    v = rng.uniform(-50, 50, (64, 3)).astype(np.float32)
    want = np.asarray(jso3.rotate_axis_angle(jnp.asarray(aa), jnp.asarray(v)))
    got = tso3.rotate_axis_angle(_t(aa), _t(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    # the matrix form is the same rotation
    Rm = tso3.axis_angle_to_matrix(_t(aa))
    np.testing.assert_allclose(tso3.matmul(Rm, _t(v)[..., None])[..., 0],
                               got, rtol=0, atol=1e-5)


def test_np_pose_helpers_equal_jax(rng):
    from vloam_tpu.geometry import np_pose as jnpp
    from vloam_tpu_torch.geometry import np_pose as tnpp

    q = rng.normal(size=(9, 4))
    t = rng.normal(size=(9, 3))
    np.testing.assert_array_equal(tnpp.quats_to_mats(q), jnpp.quats_to_mats(q))
    T = tnpp.qt_to_T(q, t)
    np.testing.assert_array_equal(T, jnpp.qt_to_T(q, t))
    np.testing.assert_array_equal(tnpp.inv_T(T), jnpp.inv_T(T))
    np.testing.assert_array_equal(tnpp.mat_cumprod(T), jnpp.mat_cumprod(T))


@pytest.mark.parametrize("subpixel", [True, False])
def test_detect_keypoints_matches_jax(frames, subpixel):
    cfg = dataclasses.replace(VO, subpixel=subpixel)
    for img in frames[0]:
        xj, sj, mj = map(np.asarray, jf.detect_keypoints(jnp.asarray(img),
                                                         cfg))
        xt, st, mt = (a.numpy() for a in tf.detect_keypoints(_t(img), cfg))
        assert mj.sum() > 50
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_array_equal(np.floor(xt), np.floor(xj))
        np.testing.assert_allclose(xt, xj, rtol=0,
                                   atol=1e-5 if subpixel else 0)
        np.testing.assert_allclose(st, sj, rtol=1e-6, atol=0)


@pytest.mark.parametrize("p", [16, 24])
def test_zncc_plain_matches_pallas_and_xla(frames, p):
    img = frames[0][0]
    cfg = dataclasses.replace(VO, descriptor_patch=p)
    xy, _, mask = jf.detect_keypoints(jnp.asarray(img), cfg)
    xy_np, mask = np.asarray(xy), np.asarray(mask)
    # the Pallas kernel needs a width of >= 384 lanes: pad as
    # tests/test_vision.py does and describe the padded image on both sides
    imp = np.asarray(jnp.pad(jnp.asarray(img), ((0, 0), (0, 384 - W)),
                             mode="edge"))
    pallas = np.asarray(jf._describe_zncc_pallas(jnp.asarray(imp), xy, p,
                                                 interpret=True))
    got = tf.zncc_describe_plain(_t(imp), _t(xy_np), p).numpy()
    assert got.shape == (len(xy_np), p * p)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.all(got == 0, axis=1),
                                  np.all(pallas == 0, axis=1))

    xla = np.asarray(jf.describe_keypoints(jnp.asarray(img), xy, cfg))
    got = tf.describe_keypoints(_t(img), _t(xy_np), cfg).numpy()
    assert mask.sum() > 50
    np.testing.assert_allclose(got[mask], xla[mask], rtol=0, atol=1e-5)


def test_zncc_floor_zeroes_flat_patches(rng):
    """A patch whose centred norm is below 1e-3 gives a zero row in the
    port and in the Pallas kernel; the XLA form scales its noise to unit
    norm. A patch just above the floor is normalized by all three."""
    p = 16
    img = rng.uniform(0.2, 0.8, (64, 384)).astype(np.float32)
    img[0:32, 0:32] = 0.5  # exactly constant
    img[0:32, 100:132] = 0.5 + rng.uniform(-1e-5, 1e-5, (32, 32))
    img[0:32, 200:232] = 0.5 + rng.uniform(-1e-2, 1e-2, (32, 32))
    # 8 rows: the Pallas grid takes keypoints in blocks of 8
    xy = np.array([[16.0, 16.0], [116.0, 16.0], [216.0, 16.0], [300.0, 40.0],
                   [0.0, 0.0], [383.0, 63.0], [40.5, 30.9], [150.0, 50.0]],
                  np.float32)
    got = tf.zncc_describe_plain(_t(img), _t(xy), p).numpy()
    pallas = np.asarray(jf._describe_zncc_pallas(
        jnp.asarray(img), jnp.asarray(xy), p, interpret=True))
    xla = np.asarray(jf.describe_keypoints(
        jnp.asarray(img), jnp.asarray(xy),
        dataclasses.replace(VO, descriptor_patch=p)))
    norms = np.linalg.norm(got, axis=1)
    np.testing.assert_array_equal(norms[[0, 1, 4]], 0.0)  # (0, 0) clips
    np.testing.assert_allclose(norms[[2, 3, 5, 6, 7]], 1.0, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    assert abs(np.linalg.norm(xla[1]) - 1.0) < 1e-3  # noise, normalized
    np.testing.assert_allclose(got[[2, 3, 5, 6, 7]], xla[[2, 3, 5, 6, 7]],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", kernel_cases.zncc_cases(),
                         ids=lambda c: c.name)
def test_zncc_plain_crafted_cases(case):
    """zncc_describe_plain (what K3 computes) against the Pallas kernel in
    interpret mode on the crafted cases of vloam_tpu_torch/tools/
    kernel_cases.py: keypoints at the corners and past every edge, negative
    and .999 coordinates, constant patches and patches on either side of the
    1e-3 floor, p = 24, 16 and 7, images of 390 and 397 columns."""
    got = tf.zncc_describe_plain(_t(case.img), _t(case.xy), case.p).numpy()
    pallas = np.asarray(jf._describe_zncc_pallas(
        jnp.asarray(case.img), jnp.asarray(case.xy), case.p, interpret=True))
    assert got.shape == (len(case.xy), case.p * case.p)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    zero = np.all(got == 0, axis=1)
    np.testing.assert_array_equal(zero, np.all(pallas == 0, axis=1))
    if case.name.startswith("flat_patches"):
        # constant 0.5, 0 and 1, norm below, above, below, above, half flat
        np.testing.assert_array_equal(
            zero, [True, True, True, True, False, True, False, False])
    else:
        assert not zero.any()
    np.testing.assert_allclose(np.linalg.norm(got[~zero], axis=1), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("select", ["knn", "nn"])
def test_match_descriptors_matches_jax(jax_vision, select):
    kps, descs, _ = jax_vision
    (_, _, m0), (_, _, m1) = kps
    ij, vj = map(np.asarray, jf.match_descriptors(
        jnp.asarray(descs[0]), jnp.asarray(m0), jnp.asarray(descs[1]),
        jnp.asarray(m1), VO.match_ratio, select=select))
    it, vt = tf.match_descriptors(_t(descs[0]), _t(m0), _t(descs[1]),
                                  _t(m1), VO.match_ratio, select=select)
    assert vj.sum() > 20
    np.testing.assert_array_equal(vt.numpy(), vj)
    np.testing.assert_array_equal(it.numpy(), ij)


def test_depth_grid_and_query_match_jax(frames, jax_vision):
    _, scans, _, P = frames
    kps, _, gj = jax_vision
    pts = scans[0]
    mask = np.ones(len(pts), bool)
    mask[::7] = False
    gj = jdm.build_depth_grid(jnp.asarray(pts), jnp.asarray(mask),
                              jnp.asarray(P), VO)
    gt = tdm.build_depth_grid(_t(pts), _t(mask), _t(P), VO)
    np.testing.assert_array_equal(gt.cnt.numpy(), np.asarray(gj.cnt))
    assert int(gt.cnt.sum()) > 1000
    for a, b in zip(gt[:3], gj[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    xy = np.trunc(kps[0][0])
    xy = np.concatenate([xy, [[0.0, 0.0], [W - 1.0, H - 1.0]]]).astype(
        np.float32)
    for spread in (0.0, 1.0):
        cfg = dataclasses.replace(VO, max_depth_spread=spread)
        zj = np.asarray(jdm.query_depth(gj, jnp.asarray(xy), cfg))
        zt = tdm.query_depth(gt, _t(xy), cfg).numpy()
        assert (zj > 0).sum() >= 10 and (zj == -1).sum() > 2
        np.testing.assert_array_equal(zt == -1, zj == -1)
        np.testing.assert_allclose(zt, zj, rtol=1e-5, atol=1e-5)


def test_depth_grid_cell_sums_add_in_point_order(rng):
    """The depth grid's per-cell sums equal a sequential float32 sum of
    each cell's values in point order, bit for bit, on values whose sum
    depends on the order (magnitudes 1e-3 to 1e7 of both signs in the same
    cells; the sum in reverse order differs). Empty cells sum to 0, and so
    does the last cell, the dump, which takes the most points here."""
    n, n_cells = 4000, 60
    cell = rng.integers(0, n_cells - 4, n)  # cells 56-58 stay empty
    cell[::3] = n_cells - 1
    vals = (rng.normal(size=(n, 4))
            * 10.0 ** rng.integers(-3, 8, (n, 4))).astype(np.float32)
    got = tdm.cell_sums(_t(cell), _t(vals), n_cells).numpy()

    def sequential(idx):
        acc = np.zeros((n_cells, 4), np.float32)
        for i in idx:
            acc[cell[i]] = acc[cell[i]] + vals[i]
        return acc

    want = sequential(range(n))
    assert got.dtype == np.float32 and got.shape == (n_cells, 4)
    np.testing.assert_array_equal(got[:-1], want[:-1])
    assert (got[-4:] == 0).all()
    assert not np.array_equal(sequential(range(n - 1, -1, -1))[:-1],
                              want[:-1])


def _vo_inputs(rng, n=300):
    """A fused VO residual's operands: 3D points at depth, bearings, the
    3D-2D / epipolar split and the row weights."""
    X0 = rng.uniform([-10, -3, 5], [10, 3, 40], (n, 3)).astype(np.float32)
    x1 = rng.uniform(-0.8, 0.8, (n, 2)).astype(np.float32)
    x0 = (X0[:, :2] / X0[:, 2:3]).astype(np.float32)
    sel = rng.random(n) < 0.6
    ones = np.ones((n, 1), np.float32)
    return (_t(X0), _t(x1), _t(np.concatenate([x0, ones], 1)),
            _t(np.concatenate([x1, ones], 1)), _t(sel[:, None]),
            _t((rng.random(n) < 0.9).astype(np.float32)))


@pytest.mark.parametrize("angle", [0.0, 1e-4, 0.05, 0.4, 1.2])
def test_vo_jacobian_equals_jacfwd(rng, angle):
    """The closed-form VO Jacobian (3D-2D and epipolar rows, across the
    series and closed-form branches of J_r) equals the float64 jacfwd of
    the same residual at the additive step (dw, dt) = 0."""
    from torch.func import jacfwd

    X0, x1, b0, b1, sel, w_rows = _vo_inputs(rng)
    axis = rng.normal(size=3)
    x = _t(np.concatenate([axis / np.linalg.norm(axis) * angle,
                           rng.normal(0, 0.5, 3)]).astype(np.float32))
    fam = tvo.vo_family(x, X0, x1, b0, b1, sel, w_rows)
    np.testing.assert_array_equal(
        fam.r.numpy(), tvo.vo_residual(x, X0, x1, b0, b1, sel)[0].numpy())
    args = [a.double() for a in (x, X0, x1, b0, b1)]
    Jf = jacfwd(lambda d: tvo.vo_residual(args[0] + d, *args[1:], sel)[0])(
        torch.zeros(6, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(fam.J.numpy(), Jf, rtol=0,
                               atol=2e-5 * np.abs(Jf).max())


def test_solve_vo_matches_jax(frames, jax_vision):
    """One VO solve on JAX's matches, keypoints and depth grid, seeded off
    the solution, with the reference's int truncation and without."""
    K = frames[2]
    kps, descs, gj = jax_vision
    (xy0, _, m0), (xy1, _, m1) = kps
    idx, ok = jf.match_descriptors(
        jnp.asarray(descs[0]), jnp.asarray(m0), jnp.asarray(descs[1]),
        jnp.asarray(m1), VO.match_ratio)
    curr = xy1[np.asarray(idx)]
    a0 = np.array([0.001, -0.01, 0.002], np.float32)
    t0 = np.array([0.02, 0.0, -0.9], np.float32)
    gt = tdm.DepthGrid(*(_t(np.asarray(g)) for g in gj))
    for subpixel in (True, False):
        cfg = dataclasses.replace(VO, subpixel=subpixel)
        aj, tj, n32j, n22j = jvo.solve_vo(
            jnp.asarray(xy0), jnp.asarray(curr), ok, gj, jnp.asarray(K),
            jnp.asarray(a0), jnp.asarray(t0), cfg)
        at, tt, n32t, n22t = tvo.solve_vo(
            _t(xy0), _t(curr), _t(np.asarray(ok)), gt,
            _t(np.linalg.inv(K)), _t(a0), _t(t0), cfg)
        assert int(n32j) > 5 and int(n32j) + int(n22j) > 20
        assert (int(n32t), int(n22t)) == (int(n32j), int(n22j))
        assert np.abs(np.asarray(tj) - t0).max() > 1e-3  # it moved
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-4)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)


def test_similarity_is_full_precision(rng):
    """The matcher's product is exact to float32 rounding of the float64
    product (the JAX form asks for Precision.HIGHEST)."""
    a = rng.normal(size=(64, 576)).astype(np.float32)
    b = rng.normal(size=(48, 576)).astype(np.float32)
    want = (a.astype(np.float64) @ b.astype(np.float64).T).astype(np.float32)
    np.testing.assert_array_equal(tf.similarity(_t(a), _t(b)).numpy(), want)
