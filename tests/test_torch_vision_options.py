"""The port's alternate VO options against the JAX reference, on the CPU at
the small test profile (tests/test_pipeline.py::small_cfg: 320 x 96
images), on uint8-quantized synthetic frames and crafted images.

- Response maps, against the reference's functions as detect_keypoints runs
  them (under jax.jit):
  - fast_response, the ORB gate (FAST > 0) and mean_pool2 bit for bit (the
    FAST excess adds in circle order, as XLA's CPU sum over the circle axis);
  - harris_response bit for bit (the port emulates the two multiply-adds
    XLA contracts in it);
  - multiscale_fast_response (BRISK) bit for bit against the reference
    called op by op. Under jax.jit XLA fuses the second pyramid level into
    the FAST fusion and adds each 2 x 2 block's row pairs first; that
    moves some of its responses by an ulp (<= 1.5e-6 here), tested within
    rtol 1e-6;
  - gauss_blur and dog_response within rtol 1e-5 / atol 1e-6 (XLA's
    convolution adds the taps in another order: <= 1.8e-7 in a blur);
  - hessian_response within rtol 1e-5 / atol 5e-6: the blur's differences
    pass through two derivatives and the (s^2)^2 = 1678 normalization of
    s = 6.4 (54 of 30720 pixels exceed atol 1e-6, by <= 2.6e-6, at a
    response scale of 1.7).
- detect_keypoints for each of the five detectors on two frames: masks
  equal and integer positions equal (subpixel off); scores identical for
  fast and orb, within their responses' tolerances for brisk, sift and
  akaze.
  Equal FAST scores keep the reference's tie order (lower index first) on
  a crafted image of identical corners.
- ORB descriptors: _brief_pairs and _ic_angle_grids equal the reference's;
  orb_describe bits equal on every detected keypoint and on >= 99.9% of the
  bits of 500 random interior keypoints (measured: 100% and 99.998%; a
  cos / sin an ulp apart can move a rotated sample across x.5). Masked
  rows, parked at (0, 0), start their patch at the clamped (0, 0), as
  dynamic_slice's documented clamp; the reference's CPU code clamps a
  negative start to the far corner instead, so they are held to the
  reference's rows for keypoints at (15, 15), whose patch starts at (0, 0).
  The matcher masks those rows either way.
- match_descriptors(matcher="flann"), knn and nn: valid identical to the
  reference's; the matched index identical wherever the nearest distance
  is unique, and at the same (nearest) distance where several tie (the
  reference's CPU approx_max_k orders ties as its unstable sort leaves
  them; the port takes the lowest index, as "bf").
- On CPU tensors no option reaches the kernel build.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu.data import synthetic as jsyn
from vloam_tpu.vision import features as jf
from vloam_tpu_torch.kernels import build
from vloam_tpu_torch.lidar import scan_registration as tsr
from vloam_tpu_torch.vision import features as tf
from vloam_tpu_torch.vision import optical_flow as tof

from test_pipeline import small_cfg

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# OpenMP pool stalls each small parallel CPU op when they are
# oversubscribed.
torch.set_num_threads(1)

VO = small_cfg().vo
W, H = VO.img_width, VO.img_height
FAST_THR = 0.06  # tests/test_vision.py's threshold for the synthetic frames
DETECTORS = ("fast", "orb", "brisk", "sift", "akaze")


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def images():
    """Two consecutive uint8-quantized frames of a synthetic drive."""
    scene = jsyn.urban_scene(2)
    K, _, _, velo_T_cam = jsyn.default_cam_calib(W, H)
    out = []
    for T in jsyn.drive_trajectory(2, speed=1.0, yaw_rate=0.015):
        img = jsyn.render_camera(scene, T @ velo_T_cam, K, W, H)
        u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        out.append(u8.astype(np.float32) / np.float32(255.0))
    return out


def _orb_gate(f, img):
    return f.fast_response(img, FAST_THR) > 0.0


RESPONSES = {
    # name: (reference, port, tolerance: None = bit for bit, or rtol, atol)
    "fast": (lambda x: jf.fast_response(x, FAST_THR),
             lambda x: tf.fast_response(x, FAST_THR), None),
    "orb_gate": (lambda x: _orb_gate(jf, x), lambda x: _orb_gate(tf, x),
                 None),
    "mean_pool2": (jf._mean_pool2, tof.mean_pool2, None),
    "harris": (lambda x: jf.harris_response(x, 5),
               lambda x: tf.harris_response(x, 5), None),
    "gauss_blur": (lambda x: jf.gauss_blur(x, 1.6),
                   lambda x: tf.gauss_blur(x, 1.6), (1e-5, 1e-6)),
    "dog": (jf.dog_response, tf.dog_response, (1e-5, 1e-6)),
    "hessian": (jf.hessian_response, tf.hessian_response, (1e-5, 5e-6)),
}


@pytest.mark.parametrize("name", list(RESPONSES))
def test_response_matches_jax(images, name):
    ref, port, tol = RESPONSES[name]
    for img in images:
        want = np.asarray(jax.jit(ref)(jnp.asarray(img)))
        got = port(_t(img)).numpy()
        assert got.shape == want.shape and want.any()
        if tol is None:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])


def test_brisk_response_matches_jax(images):
    for img in images:
        got = tf.multiscale_fast_response(_t(img), FAST_THR).numpy()
        eager = np.asarray(jf.multiscale_fast_response(jnp.asarray(img),
                                                       FAST_THR))
        np.testing.assert_array_equal(got, eager)
        jitted = np.asarray(jax.jit(
            lambda x: jf.multiscale_fast_response(x, FAST_THR))(
                jnp.asarray(img)))
        np.testing.assert_allclose(got, jitted, rtol=1e-6, atol=0)
        assert (got > 0).mean() > 0.2


def test_mean_pool2_odd_shapes(rng):
    for shape in ((97, 321), (64, 66), (7, 200)):
        img = rng.uniform(size=shape).astype(np.float32)
        np.testing.assert_array_equal(
            tof.mean_pool2(_t(img)).numpy(),
            np.asarray(jax.jit(jf._mean_pool2)(jnp.asarray(img))))


SCORE_TOL = {"brisk": (1e-6, 0.0), "sift": (1e-5, 1e-6),
             "akaze": (1e-5, 5e-6)}


def _cfg(detector, **kw):
    return dataclasses.replace(VO, detector=detector, fast_threshold=FAST_THR,
                               subpixel=False, **kw)


@pytest.mark.parametrize("detector", DETECTORS)
def test_detect_keypoints_matches_jax(images, detector):
    cfg = _cfg(detector)
    for img in images:
        xj, sj, mj = map(np.asarray, jf.detect_keypoints(jnp.asarray(img),
                                                         cfg))
        xt, st, mt = (a.numpy() for a in tf.detect_keypoints(_t(img), cfg))
        assert mj.sum() > 50, (detector, mj.sum())
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_array_equal(xt, xj)
        if detector in ("fast", "orb"):
            np.testing.assert_array_equal(st, sj)
        else:  # the tolerances of their responses
            rtol, atol = SCORE_TOL[detector]
            np.testing.assert_allclose(st, sj, rtol=rtol, atol=atol)


def test_equal_fast_corners_keep_the_reference_order():
    """Identical bright squares on a dark image: every corner has the same
    FAST score, so the top-k order is the tie rule alone (lower flat index
    first). max_keypoints below the corner count cuts inside the ties."""
    img = np.zeros((96, 320), np.float32)
    for y in range(20, 76, 14):
        for x in range(20, 300, 14):
            img[y:y + 6, x:x + 6] = 0.8
    for det in ("fast", "orb", "brisk"):
        cfg = _cfg(det, max_keypoints=48)
        xj, sj, mj = map(np.asarray, jf.detect_keypoints(jnp.asarray(img),
                                                         cfg))
        xt, st, mt = (a.numpy() for a in tf.detect_keypoints(_t(img), cfg))
        assert mj.all() and len(set(sj[:8].tolist())) == 1, det
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(st, sj)


def test_orb_tables_equal_jax():
    for n_bits in (256, 64):
        for got, want in zip(tf._brief_pairs(n_bits, 31),
                             jf._brief_pairs(n_bits, 31)):
            np.testing.assert_array_equal(got, np.asarray(want))
    for got, want in zip(tf._ic_angle_grids(31), jf._ic_angle_grids(31)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_orb_describe_matches_jax(images, rng):
    cfg = _cfg("orb", descriptor="orb")
    img = images[0]
    xy, _, m = jf.detect_keypoints(jnp.asarray(img), cfg)
    m = np.asarray(m)
    want = np.asarray(jf.orb_describe(jnp.asarray(img), xy, cfg))
    got = tf.orb_describe(_t(img), _t(xy)).numpy()
    assert got.shape == (VO.max_keypoints, 256) and 50 < m.sum() < len(m)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(got[m], want[m])
    # masked rows: the patch at the clamped start (0, 0)
    at15 = np.where(m[:, None], np.asarray(xy), 15.0).astype(np.float32)
    want15 = np.asarray(jf.orb_describe(jnp.asarray(img), jnp.asarray(at15),
                                        cfg))
    np.testing.assert_array_equal(got[~m], want15[~m])
    # random interior keypoints, fractional coordinates included
    xy_r = np.stack([rng.uniform(15, W - 16, 500),
                     rng.uniform(15, H - 16, 500)], 1).astype(np.float32)
    same = (tf.orb_describe(_t(img), _t(xy_r)).numpy()
            == np.asarray(jf.orb_describe(jnp.asarray(img),
                                          jnp.asarray(xy_r), cfg)))
    assert same.mean() >= 0.999, same.mean()
    # describe_keypoints dispatches on the descriptor
    np.testing.assert_array_equal(
        tf.describe_keypoints(_t(img), _t(xy), cfg).numpy(), got)
    assert tf.descriptor_dim(cfg) == 256 and tf.descriptor_dim(VO) == 24 ** 2


@pytest.mark.parametrize("select", ["knn", "nn"])
def test_flann_matches_jax(images, select):
    cfg = _cfg("orb", descriptor="orb")
    descs, masks = [], []
    for img in images:
        xy, _, m = jf.detect_keypoints(jnp.asarray(img), cfg)
        descs.append(np.asarray(jf.orb_describe(jnp.asarray(img), xy, cfg)))
        masks.append(np.asarray(m))
    ij, vj = map(np.asarray, jf.match_descriptors(
        jnp.asarray(descs[0]), jnp.asarray(masks[0]), jnp.asarray(descs[1]),
        jnp.asarray(masks[1]), 0.8, matcher="flann", select=select))
    it, vt = tf.match_descriptors(_t(descs[0]), _t(masks[0]), _t(descs[1]),
                                  _t(masks[1]), 0.8, matcher="flann",
                                  select=select)
    it, vt = it.numpy(), vt.numpy()
    assert vj.sum() >= 10
    np.testing.assert_array_equal(vt, vj)
    # Hamming distances are discrete, so equal nearest distances are
    # common. The port takes the lowest index among them, as "bf"; the
    # reference's approx_max_k on the CPU returns exact distances but orders
    # equal ones as its unstable sort leaves them. Both pick a nearest
    # descriptor on every row, and the same one wherever the nearest is
    # unique (every row the ratio test keeps).
    d = np.sqrt(np.maximum(2.0 - 2.0 * (descs[0].astype(np.float64)
                                        @ descs[1].astype(np.float64).T),
                           0.0))
    d = np.where(masks[1][None, :], d, np.inf)
    rows = np.arange(len(ij))
    np.testing.assert_array_equal(d[rows, it], d[rows, ij])
    unique = (d == d.min(axis=1, keepdims=True)).sum(axis=1) == 1
    np.testing.assert_array_equal(it[unique], ij[unique])
    if select == "knn":
        assert unique[vj].all()
    bf = tf.match_descriptors(_t(descs[0]), _t(masks[0]), _t(descs[1]),
                              _t(masks[1]), 0.8, select=select)
    np.testing.assert_array_equal(bf[0].numpy(), it)
    np.testing.assert_array_equal(bf[1].numpy(), vt)


def test_options_on_cpu_never_reach_the_kernel_build(images, monkeypatch):
    """Every option's CPU path is plain torch: with the kernel build made to
    raise, detection, ORB description, FLANN matching and both sector
    selections still run on CPU tensors."""

    def refuse(*a, **k):
        raise AssertionError("the kernel build was reached from the CPU")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build", refuse)
    img = _t(images[0])
    for det in DETECTORS + ("shi_tomasi",):
        xy, _, m = tf.detect_keypoints(img, _cfg(det))
        assert m.any()
    desc = tf.describe_keypoints(img, xy, _cfg("orb", descriptor="orb"))
    tf.match_descriptors(desc, m, desc, m, matcher="flann")
    tf.describe_keypoints(img, xy, VO)
    rng = np.random.default_rng(0)
    curv = _t(rng.uniform(0, 0.3, (4, 300)).astype(np.float32))
    bf = torch.zeros((4, 300), dtype=torch.int32)
    counts = torch.tensor([300, 200, 50, 0], dtype=torch.int32)
    scanreg = small_cfg().scanreg
    for strict in (True, False):
        cfg = dataclasses.replace(scanreg, strict_sector_order=strict)
        select = tsr.select_rings if strict else tsr.select_rings_batched
        assert (select(curv, bf, counts, cfg) != 0).any()
