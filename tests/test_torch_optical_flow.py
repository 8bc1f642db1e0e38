"""The port's LK optical flow, CLAHE and bucket NMS (vision/optical_flow.py,
vision/features.py) against the JAX package on the CPU, and the combined
engine (VloamEngine) with each of the four VO options that use them against
the JAX engine.

- build_pyramid: bit-identical (each 2 x 2 block summed in XLA's order, at
  level widths above 32 pixels, where XLA's CPU reduce adds row by row).
- lk_flow on rendered frame pairs and on tests/test_vision.py's 3-pixel
  shift: status identical, xy1 within 1e-3 px (each level sums 225 window
  samples, in another order than XLA's, over 10 iterations).
- clahe within 1e-6 (the per-tile excess sums and the tile-centre
  divisions round differently in the last bit); bucket_nms's mask
  identical, crafted equal scores included.
- VloamEngine with optical_flow_match, lowtex_fallback, clahe and
  keypoint_nms each on: tests/test_torch_vloam_engine.py's _check_rows
  tolerances (LO 1e-3 m, MO 1e-2 m, VO 2e-3 m, n32 / n22 identical).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vloam_tpu import vloam_step as jvs
from vloam_tpu.vision import features as jf
from vloam_tpu.vision import optical_flow as jof
from vloam_tpu_torch import vloam_step as tvs
from vloam_tpu_torch.vision import features as tf
from vloam_tpu_torch.vision import optical_flow as tof

from test_pipeline import small_cfg, synth_setup
from test_torch_vloam_engine import _check_rows
from test_vision import CFG, make_frame

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# OpenMP pool stalls each small parallel CPU op when they are
# oversubscribed.
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("shape,levels", [((96, 320), 3), ((97, 321), 3),
                                          ((375, 1242), 3), ((75, 291), 4)])
def test_build_pyramid_bit_identical(shape, levels):
    img = np.random.default_rng(shape[1]).random(shape).astype(np.float32)
    want = jof.build_pyramid(jnp.asarray(img), levels)
    got = tof.build_pyramid(_t(img), levels)
    assert len(got) == len(want) == levels
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _frame_pair(case):
    """(img0, img1) of a flow case: consecutive rendered frames of a drive,
    or tests/test_vision.py's frame rolled by 3 pixels."""
    if case == "shift":
        img, *_ = make_frame(4)
        return img, np.roll(img, 3, axis=1)
    T1 = np.eye(4)
    T1[:3, 3] = [0.8, 0.05, 0.0]
    return make_frame(1)[0], make_frame(1, pose=T1)[0]


@pytest.mark.parametrize("case", ["rendered", "shift"])
def test_lk_flow_matches_jax(case):
    img0, img1 = _frame_pair(case)
    xy0, _, mask = jf.detect_keypoints(jnp.asarray(img0), CFG)
    want_xy, want_ok = jof.lk_flow(jnp.asarray(img0), jnp.asarray(img1), xy0,
                                   CFG)
    got_xy, got_ok = tof.lk_flow(_t(img0), _t(img1), _t(xy0), CFG)
    want_ok = np.asarray(want_ok)
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    assert want_ok.sum() > 20
    np.testing.assert_allclose(got_xy.numpy(), np.asarray(want_xy), rtol=0,
                               atol=1e-3)
    if case == "shift":
        sel = np.asarray(mask) & want_ok
        flow = (got_xy.numpy() - np.asarray(xy0))[sel]
        np.testing.assert_allclose(np.median(flow, axis=0), [3.0, 0.0],
                                   atol=0.35)


@pytest.mark.parametrize("shape", [None, (375, 1242), (37, 51)])
def test_clahe_matches_jax(shape):
    img = (make_frame(4)[0] if shape is None else
           np.random.default_rng(7).random(shape).astype(np.float32))
    want = np.asarray(jf.clahe(jnp.asarray(img)))
    got = tf.clahe(_t(img)).numpy()
    assert got.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bucket,max_total", [(100, 400), (100, 40),
                                              (37, 40), (37, 10)])
def test_bucket_nms_matches_jax(bucket, max_total):
    img, *_ = make_frame(4)
    xy, score, mask = jf.detect_keypoints(jnp.asarray(img), CFG)
    xy, score, mask = map(np.array, (xy, score, mask))
    # crafted equal scores: every third keypoint takes its neighbour's
    score[2::3] = score[1:-1:3][:len(score[2::3])]
    for s in (score, np.full_like(score, 0.5)):
        want = np.asarray(jf.bucket_nms(jnp.asarray(xy), jnp.asarray(s),
                                        jnp.asarray(mask), 320, 96, bucket,
                                        bucket, max_total))
        got = tf.bucket_nms(_t(xy), _t(s), _t(mask), 320, 96, bucket, bucket,
                            max_total).numpy()
        np.testing.assert_array_equal(got, want)
        assert want.any() and not (want & ~mask).any()


N = 4
CFG_V = small_cfg(detach_VO_LO=False)


@pytest.fixture(scope="module")
def drive():
    calib, frames, _ = synth_setup(N, seed=2)
    return calib, list(frames())


@pytest.mark.parametrize("option", [
    {"optical_flow_match": True},
    # min_vo_matches above the drive's ~28 descriptor matches a frame: every
    # frame falls back to flow, whose solve is exported but seeds no LO
    {"lowtex_fallback": True, "min_vo_matches": 30},
    {"clahe": True},
    # 14 buckets of 50 x 50 px, 7 keypoints each, 100 in all
    {"keypoint_nms": True, "nms_bucket": 50, "nms_max_total": 100},
], ids=lambda o: next(iter(o)))
def test_engine_option_matches_jax(drive, option):
    calib, frames = drive
    cfg = CFG_V.replace(vo=dataclasses.replace(CFG_V.vo, **option))
    outs = []
    for eng in (jvs.VloamEngine(cfg, calib, chunk=2),
                tvs.VloamEngine(cfg, calib, chunk=2, device="cpu")):
        for f in frames:
            eng.push(f["points"], f["image"])
        outs.append(eng.finish())
    want, got = outs
    assert np.isfinite(got).all()
    _check_rows(got, want, calib)
