"""The port's SE(3) poses, SO(3) additions, factor library, essential-matrix
RANSAC and trajectory plots against the JAX reference, on the CPU, on numpy
inputs made from a seed.

- so3.quat_from_matrix (random rotations, the identity and half turns,
  whose candidate scores tie: the first index wins) and
  quat_slerp_identity within 1e-6.
- Pose: identity, compose, inverse, apply (one pose and a batch, with and
  without a point axis), matrix, matrix34, from_matrix, from_axis_angle,
  as_float64 and pose_from_np_matrix within 1e-6.
- The eight factors within 1e-6 (relative to their scale of ~10).
- essential_ransac_from_samples on minimal samples drawn by the reference's
  own jax.random.choice call (the port cannot reproduce the threefry
  stream):
  - against the reference run in float64 (jax.enable_x64): inlier masks and
    counts identical, R and t within 1e-4. The port's SVDs run in float64,
    its Sampson scores and votes in float32;
  - against the reference in float32 on the 2048-point, 30%-outlier scene
    of chip_smoke.py's phase V5: masks and counts identical, R and t
    within 1e-4. On an ill-conditioned sample the reference's float32 SVD
    drifts: on tests/test_ransac_and_checkpoint.py's 400-point scene with
    10 invalid rows and a 1e-6 threshold it returns t 4.0e-3 from the
    truth and one inlier more, where its float64 run and the port agree
    with the truth to 1e-7, so that scene is held to the float64 run.
  - estimate_essential_ransac (samples from a torch.Generator) is
    reproducible for a seed and recovers the pose within the reference
    test's bounds; phase V5's own draw recovers it within 1e-3 (the gate
    chip_smoke.py holds the card to).
- plot_trajectories / plot_pose_files write PNGs (skipped without
  matplotlib).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from vloam_tpu.geometry import Pose as JPose
from vloam_tpu.geometry import pose_from_np_matrix as jpose_from_np
from vloam_tpu.geometry import so3 as jso3
from vloam_tpu.solver import factors as jfac
from vloam_tpu.vision import ransac as jr
from vloam_tpu_torch.geometry import Pose, pose_from_np_matrix
from vloam_tpu_torch.geometry import so3 as tso3
from vloam_tpu_torch.solver import factors as tfac
from vloam_tpu_torch.vision import ransac as tr

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# OpenMP pool stalls each small parallel CPU op when they are
# oversubscribed.
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_quat_from_matrix_matches_jax(rng):
    q = _quats(rng, 64)
    m = np.asarray(jso3.quat_to_matrix(jnp.asarray(q)))
    special = np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0]),
                        np.diag([-1.0, 1.0, -1.0]),
                        np.diag([-1.0, -1.0, 1.0]),
                        Rotation.from_rotvec([0.0, 0.0, np.pi]).as_matrix()]
                       ).astype(np.float32)
    m = np.concatenate([m, special])
    want = np.asarray(jso3.quat_from_matrix(jnp.asarray(m)))
    got = tso3.quat_from_matrix(_t(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[64], [0.0, 0.0, 0.0, 1.0])


def test_quat_slerp_identity_matches_jax(rng):
    q = _quats(rng, 32)
    for s in (0.0, 0.37, 1.0):
        np.testing.assert_allclose(
            tso3.quat_slerp_identity(_t(q), s).numpy(),
            np.asarray(jso3.quat_slerp_identity(jnp.asarray(q), s)),
            rtol=0, atol=1e-6)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-6)


def _close_pose(got, want):
    _close(got.q, want.q)
    _close(got.t, want.t)


def test_pose_matches_jax(rng):
    qa, qb = _quats(rng, 16), _quats(rng, 16)
    ta = rng.normal(size=(16, 3)).astype(np.float32)
    tb = rng.normal(size=(16, 3)).astype(np.float32)
    pts = rng.normal(size=(16, 3)).astype(np.float32)
    cloud = rng.normal(size=(16, 5, 3)).astype(np.float32)
    A, B = Pose(_t(qa), _t(ta)), Pose(_t(qb), _t(tb))
    JA, JB = JPose(jnp.asarray(qa), jnp.asarray(ta)), JPose(jnp.asarray(qb),
                                                           jnp.asarray(tb))
    _close_pose(A.compose(B), JA.compose(JB))
    _close_pose(A.inverse(), JA.inverse())
    _close(A.apply(_t(pts)), JA.apply(jnp.asarray(pts)))
    _close(A.apply(_t(cloud)), JA.apply(jnp.asarray(cloud)))
    one = Pose(_t(qa[0]), _t(ta[0]))
    jone = JPose(jnp.asarray(qa[0]), jnp.asarray(ta[0]))
    _close(one.apply(_t(pts)), jone.apply(jnp.asarray(pts)))
    _close(A.matrix(), JA.matrix())
    _close(A.matrix34(), JA.matrix34())
    m = np.asarray(JA.matrix())
    _close_pose(Pose.from_matrix(_t(m)), JPose.from_matrix(jnp.asarray(m)))
    aa = rng.normal(size=(16, 3)).astype(np.float32)
    _close_pose(Pose.from_axis_angle(_t(aa), _t(ta)),
                JPose.from_axis_angle(jnp.asarray(aa), jnp.asarray(ta)))
    ident, jident = Pose.identity(batch=(3,)), JPose.identity(batch=(3,))
    _close_pose(ident, jident)
    assert ident.q.dtype == torch.float32 and ident.q.shape == (3, 4)
    f64 = A.as_float64()
    assert f64.q.dtype == np.float64 and isinstance(f64.t, np.ndarray)
    _close_pose(f64, JA.as_float64())
    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec([0.3, -0.2, 0.1]).as_matrix()
    T[:3, 3] = [1.0, 2.0, -3.0]
    got, want = pose_from_np_matrix(T), jpose_from_np(T)
    assert got.q.dtype == np.float64
    _close_pose(got, want)


def _factor_inputs(rng, n=32):
    """Camera and lidar factor inputs near a true motion, float32."""
    f = np.float32
    w = np.array([0.05, -0.02, 0.08], f)
    t = np.array([0.3, 0.1, -0.2], f)
    X0 = (rng.uniform(-5, 5, (n, 3)) + [0, 0, 10.0]).astype(f)
    X1 = (Rotation.from_rotvec(w).apply(X0) + t
          + rng.normal(0, 0.05, (n, 3))).astype(f)
    q = Rotation.from_rotvec(w).as_quat().astype(f)
    p, a, b, c = (rng.normal(size=(n, 3)).astype(f) * 5 for _ in range(4))
    n_hat = rng.normal(size=(n, 3)).astype(f)
    n_hat /= np.linalg.norm(n_hat, axis=1, keepdims=True)
    return {"w": w, "t": t, "X0": X0, "X1": X1,
            "x0b": X0[:, :2] / X0[:, 2:3], "x1b": X1[:, :2] / X1[:, 2:3],
            "q": q, "p": p, "a": a, "b": b, "c": c, "n": n_hat,
            "d": rng.normal(size=n).astype(f),
            "s": rng.uniform(0, 1, (n, 1)).astype(f)}


FACTORS = {
    "point_3d3d": ("w", "t", "X0", "X1"),
    "point_3d2d": ("w", "t", "X0", "x1b"),
    "point_2d3d": ("w", "t", "x0b", "X1"),
    "epipolar_2d2d": ("w", "t", "x0b", "x1b"),
    "lidar_edge": ("q", "t", "p", "a", "b", "s"),
    "lidar_plane": ("q", "t", "p", "a", "b", "c", "s"),
    "lidar_plane_norm": ("q", "t", "p", "n", "d"),
    "lidar_distance": ("q", "t", "p", "a"),
}


@pytest.mark.parametrize("name", list(FACTORS))
def test_factor_matches_jax(rng, name):
    x = _factor_inputs(rng)
    args = FACTORS[name]
    variants = [args]
    if args[-1] == "s":  # with and without the de-skew fraction
        variants.append(args[:-1])
    for names in variants:
        want = np.asarray(getattr(jfac, name)(
            *(jnp.asarray(x[k]) for k in names)))
        got = getattr(tfac, name)(*(_t(x[k]) for k in names)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _scene(seed, n, n_out, n_invalid, spread=(10.0, 4.0), depth=(4.0, 50.0)):
    """Normalized correspondences of a rigid motion with n_out random
    outliers first and n_invalid invalid rows last."""
    rng = np.random.default_rng(seed)
    X0 = rng.uniform([-spread[0], -spread[1], depth[0]],
                     [spread[0], spread[1], depth[1]], (n, 3))
    R = Rotation.from_rotvec([0.02, -0.04, 0.01])
    t = np.array([0.2, -0.1, 1.0])
    X1 = R.apply(X0) + t
    x0 = (X0[:, :2] / X0[:, 2:3]).astype(np.float32)
    x1 = (X1[:, :2] / X1[:, 2:3]).astype(np.float32)
    x1[:n_out] = rng.uniform(-0.5, 0.5, (n_out, 2))
    valid = np.ones(n, bool)
    valid[n - n_invalid:] = False
    return x0, x1, valid, R, t / np.linalg.norm(t)


SCENES = {
    # tests/test_ransac_and_checkpoint.py's scene, 10 rows invalid
    "reference_test": dict(seed=0, n=400, n_out=80, n_invalid=10),
    # chip_smoke.py phase V5: 2048 points, 30% outliers
    "v5": dict(seed=5, n=2048, n_out=614, n_invalid=0),
}


def _jax_draw(key, valid, n_hyp=256):
    w = jnp.asarray(valid).astype(jnp.float32)
    p = w / jnp.maximum(jnp.sum(w), 1.0)
    return np.asarray(jax.random.choice(key, len(valid), shape=(n_hyp, 8),
                                        p=p))


def _check_ransac(got, want, x0):
    q, t, inl, n = (np.asarray(a) for a in got)
    qj, tj, inlj, nj = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(inl, inlj)
    assert int(n) == int(nj) == inl.sum() > 0.5 * len(x0)
    np.testing.assert_allclose(q, qj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t, tj, rtol=0, atol=1e-4)


def _pose_error(q, t, R_true, t_true):
    rot = Rotation.from_quat(np.asarray(q, np.float64)).inv() * R_true
    return rot.magnitude(), np.abs(np.asarray(t) - t_true).max()


@pytest.mark.parametrize("thresh", [1e-6, 1e-5])
@pytest.mark.parametrize("scene", list(SCENES))
def test_essential_ransac_matches_jax_float64(scene, thresh):
    x0, x1, valid, _, _ = _scene(**SCENES[scene])
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        idx = _jax_draw(key, valid)
        want = jr.estimate_essential_ransac(
            jnp.asarray(x0, jnp.float64), jnp.asarray(x1, jnp.float64),
            jnp.asarray(valid), key, 256, thresh)
        want = [np.asarray(a) for a in want]
    got = tr.essential_ransac_from_samples(_t(idx), _t(x0), _t(x1),
                                           _t(valid), thresh)
    assert got[0].dtype == torch.float32
    _check_ransac(got, want, x0)


@pytest.mark.parametrize("thresh", [1e-6, 1e-5])
def test_essential_ransac_matches_jax_float32(thresh):
    x0, x1, valid, _, _ = _scene(**SCENES["v5"])
    key = jax.random.PRNGKey(3)
    idx = _jax_draw(key, valid)
    want = jr.estimate_essential_ransac(jnp.asarray(x0), jnp.asarray(x1),
                                        jnp.asarray(valid), key, 256, thresh)
    got = tr.essential_ransac_from_samples(_t(idx), _t(x0), _t(x1),
                                           _t(valid), thresh)
    _check_ransac(got, want, x0)


def test_estimate_essential_ransac_draws_from_the_generator():
    """Reproducible for a seed; the pose within the reference test's bounds
    (tests/test_ransac_and_checkpoint.py: 5e-3 rad, direction cosine >
    0.99): the winner is one minimal sample's E, not refined."""
    x0, x1, valid, R, t = _scene(seed=1, n=600, n_out=150, n_invalid=20)
    runs = [tr.estimate_essential_ransac(
        _t(x0), _t(x1), _t(valid), torch.Generator().manual_seed(7))
        for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    q, tt, inl, n = runs[0]
    assert not inl[~torch.from_numpy(valid)].any() and int(n) == inl.sum()
    rot, _ = _pose_error(q.numpy(), tt.numpy(), R, t)
    assert rot < 5e-3 and float(np.dot(tt.numpy(), t)) > 0.99


def test_v5_scene_recovers_the_pose():
    """chip_smoke.py phase V5's draw and gate, on the CPU: 2048 minimal
    samples' indices from torch.Generator().manual_seed(5), R within 1e-3
    rad and t within 1e-3 of the truth."""
    x0, x1, valid, R, t = _scene(**SCENES["v5"])
    p = torch.ones(len(x0)) / len(x0)
    idx = torch.multinomial(p, 256 * 8, replacement=True,
                            generator=torch.Generator().manual_seed(5))
    q, tt, inl, n = tr.essential_ransac_from_samples(
        idx.reshape(256, 8), _t(x0), _t(x1), _t(valid))
    rot, dt = _pose_error(q.numpy(), tt.numpy(), R, t)
    assert rot < 1e-3 and dt < 1e-3, (rot, dt)
    assert int(n) >= 1434  # the 1434 true inliers (and outliers that fit)


def test_plots_write_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    from vloam_tpu_torch.eval import plotting

    rng = np.random.default_rng(0)
    poses = np.tile(np.eye(4)[:3], (20, 1, 1))
    poses[:, :, 3] = np.cumsum(rng.normal(size=(20, 3)), axis=0)
    out = tmp_path / "traj.png"
    fig = plotting.plot_trajectories({"MO": poses, "VO": poses.reshape(20, 12)},
                                     out_path=str(out))
    assert out.stat().st_size > 1000 and len(fig.axes) == 2
    path = tmp_path / "MO.txt"
    np.savetxt(path, poses.reshape(20, 12))
    out2 = tmp_path / "files.png"
    plotting.plot_pose_files({"MO": str(path)}, out_path=str(out2))
    assert out2.stat().st_size > 1000
