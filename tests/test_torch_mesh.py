"""The port's distributed paths (vloam_tpu_torch/parallel/) at world size 1,
in this process (a one-rank gloo group), against the JAX package on a
1-device mesh of conftest's virtual CPU devices and against the port's own
single-device paths.

Tolerances:
- sharded_point_to_plane_gn: the pose within 1e-4 of the reference's;
- sharded_map_alignment on tests/test_sharded_mapping.py's structured
  world: the pose within 0.02 m / 5e-3 rad of the reference's (the bounds
  that test holds the reference to against the truth). The plane fit
  solves A n = -1 (5 points some 15 m out, a few cm apart) by adjugate,
  which is ill-conditioned there: the reference's float32 fit loses about
  half of the world's planes to rounding (its 0.2 m residual test fails
  them), the port's float64 fit (F5) keeps them, so the port accepts at
  least the reference's residual count and 95% of all (every query lies on
  its plane or line);
- the fused engines with a mesh against the port without one: LO within
  1e-5 (LO never touches the mesh), MO within 0.01 m, as
  tests/test_mesh_fused.py holds the reference's mesh engine to its single
  one (the windowed ring 5-NN finds the 8-cell probe's neighbours within the
  1 m gate; the LM sums in another order); VloamEngine's VO and LO within
  1e-4. Against the JAX mesh engine: LO 1e-3 m, MO 1e-2 m, VO 2e-3 m, the
  port's bounds against the JAX engines elsewhere (its LO associates with
  exact distances where the JAX engine quantizes);
- the host engine's mesh path (run_mesh_drive) the same way;
- optimize_pose_graph(mesh=) within 2e-3 of the unsharded solve, as
  tests/test_parallel.py holds the reference's; close_loops(mesh=) within
  1e-3 m / 1e-3 rad of the JAX close_loops(mesh=);
- a mesh with a checkpoint path is refused, as in the reference; the map
  and graph splits of convert.py round-trip bit for bit.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from vloam_tpu.data import synthetic
from vloam_tpu.lidar.loam_step import LoamEngine as JLoamEngine
from vloam_tpu.lidar.loam_step import unpack_outputs as j_unpack
from vloam_tpu.parallel import sharded as jsh
from vloam_tpu_torch import convert
from vloam_tpu_torch.lidar.loam_step import LoamEngine, unpack_outputs
from vloam_tpu_torch.parallel import sharded as tsh

from test_pipeline import small_cfg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    return tsh.data_mesh(device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jsh.data_mesh(jax.devices()[:1])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _scans(n, seed=11):
    scene = synthetic.urban_scene(seed)
    poses = synthetic.drive_trajectory(n, speed=1.0, yaw_rate=0.02)
    return [synthetic.simulate_scan(scene, T, n_scans=64, n_azimuth=700,
                                    seed=seed * 100 + k)
            for k, T in enumerate(poses)]


def _grid_cfg(nb, cap_c=32, cap_s=16, **kw):
    cfg = small_cfg(**kw)
    return cfg.replace(mapping=dataclasses.replace(
        cfg.mapping, map_n_buckets=nb, corner_bucket_cap=cap_c,
        surf_bucket_cap=cap_s))


def test_mesh_handle(mesh):
    assert (mesh.rank, mesh.size, mesh.backend, mesh.device.type) == \
        (0, 1, "gloo", "cpu")
    assert tsh.Mesh.axis == mesh.axis == "data" and not mesh.host_hops
    x = torch.arange(5.0)
    assert torch.equal(tsh.psum(x.clone(), mesh), x)
    assert torch.equal(tsh.ppermute_ring(x, mesh), x)
    assert torch.equal(tsh.shard_batch(x, mesh), x)
    # nothing picks another backend unasked
    with pytest.raises(ValueError, match="nccl"):
        tsh.data_mesh(device="cpu", backend="nccl")


def test_sharded_point_to_plane_gn_matches_jax(mesh, jmesh, rng):
    q_true = R.from_rotvec([0.02, -0.01, 0.03]).as_quat()
    t_true = np.array([0.3, -0.2, 0.1])
    n = 4096
    normals = rng.normal(size=(n, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    pts_world = rng.uniform(-20, 20, (n, 3))
    d = -np.sum(normals * pts_world, axis=1)
    pts = R.from_quat(q_true).inv().apply(pts_world - t_true)
    x0 = np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32)
    args = [pts, normals, d, np.ones(n)]
    xj = np.asarray(jsh.sharded_point_to_plane_gn(
        jmesh, *(jsh.shard_batch(jnp.asarray(a, jnp.float32), jmesh)
                 for a in args), jnp.asarray(x0), iterations=6))
    xt = tsh.sharded_point_to_plane_gn(
        mesh, *(tsh.shard_batch(_t(a), mesh) for a in args), _t(x0),
        iterations=6).numpy()
    np.testing.assert_allclose(xt, xj, atol=1e-4)
    np.testing.assert_allclose(xt[4:], t_true, atol=1e-2)


def test_sharded_map_alignment_matches_jax(mesh, jmesh, rng):
    from test_sharded_mapping import _problem, _run

    from vloam_tpu_torch.parallel.sharded_mapping import sharded_map_alignment

    cfg, map_corner, map_surf, c_stack, s_stack, q_true, t_true = \
        _problem(rng)
    xj, cj = _run(jmesh, cfg, map_corner, map_surf, c_stack, s_stack)
    args = []
    for a in (c_stack, s_stack, map_corner, map_surf):
        args += [tsh.shard_batch(_t(a), mesh),
                 tsh.shard_batch(torch.ones(len(a), dtype=torch.bool), mesh)]
    xt, ct = sharded_map_alignment(
        mesh, *args, _t([0, 0, 0, 1, 0, 0, 0]), cfg, return_counts=True)
    xt, xj = xt.numpy().astype(np.float64), np.asarray(xj, np.float64)
    np.testing.assert_allclose(xt[4:], xj[4:], atol=0.02)
    assert (R.from_quat(xt[:4]).inv() * R.from_quat(xj[:4])).magnitude() \
        < 5e-3
    # the port fits planes in float64 (F5); the reference's float32 fit
    # loses about half of this world's planes to rounding. Every query lies
    # on its plane or line: the port accepts nearly all of them, and at
    # least the residuals the reference accepts.
    n = len(c_stack) + len(s_stack)
    assert float(cj[0]) <= float(ct[0]) and float(ct[0]) >= 0.95 * n, (ct, cj)
    np.testing.assert_allclose(xt[4:], t_true, atol=0.02)


def test_run_mesh_drive_matches_jax(mesh, jmesh):
    """The host engine's mesh path (MeshLaserMapping over the flat map)
    over 3 frames: against the JAX run_mesh_drive and against the port's
    host stages without a mesh."""
    from vloam_tpu.parallel.mesh_pipeline import run_mesh_drive as j_drive

    from vloam_tpu_torch.lidar.mapping import LaserMapping
    from vloam_tpu_torch.lidar.odometry import LaserOdometry
    from vloam_tpu_torch.lidar.scan_registration import register_scan
    from vloam_tpu_torch.data.synthetic import pad_scan
    from vloam_tpu_torch.parallel.mesh_pipeline import run_mesh_drive

    cfg = _grid_cfg(1 << 11, 16, 16)
    scans = _scans(3)
    want = j_drive(cfg, scans, jmesh)
    got = run_mesh_drive(cfg, scans, mesh, device="cpu")
    for k, tol in (("t_w_lo", 1e-3), ("t_w_mo", 1e-2)):
        np.testing.assert_allclose(got[k], want[k], atol=tol, err_msg=k)
    lo = LaserOdometry(cfg.lo, device="cpu")
    mo = LaserMapping(cfg.mapping, device="cpu")
    for k, pts in enumerate(scans):
        padded, n = pad_scan(pts, cfg.lidar.max_points)
        feats = register_scan(torch.from_numpy(padded), n, cfg.lidar,
                              cfg.scanreg)
        lo_out = lo.step(feats)
        mo_out = mo.step(feats.less_sharp, feats.less_flat, lo_out["q_w"],
                         lo_out["t_w"])
        np.testing.assert_allclose(got["t_w_lo"][k], lo_out["t_w"],
                                   atol=1e-5)
        np.testing.assert_allclose(got["t_w_mo"][k], mo_out["t_w"],
                                   atol=1e-2)


def test_mesh_loam_engine_matches_jax_and_single(mesh, jmesh):
    """LoamEngine(mesh=) at the production grid (2^17 buckets, caps 32 /
    16) over a 6-frame drive, against the JAX mesh engine and the port's
    single-device engine; the window's peak active rows within the window
    and within 1% of the reference's. The reference's own mesh engine
    leaves its single engine by millimetres from the first mapped frame on
    (the window's exact 5-NN and the 8-cell probe accept different
    residuals; the LMs sum in other orders): the frame-by-frame MO gaps of
    both packages are printed (-s) and held to the same 0.01 m."""
    cfg = _grid_cfg(1 << 17)
    scans = _scans(6)
    jeng = JLoamEngine(cfg, chunk=3, mesh=jmesh, mesh_window_rows=1024)
    jsingle = JLoamEngine(cfg, chunk=3)
    for s in scans:
        jeng.push(s)
        jsingle.push(s)
    want, jref = j_unpack(jeng.finish()), j_unpack(jsingle.finish())
    eng = LoamEngine(cfg, chunk=3, mesh=mesh, mesh_window_rows=1024,
                     device="cpu")
    single = LoamEngine(cfg, chunk=3, device="cpu")
    for s in scans:
        eng.push(s)
        single.push(s)
    got, ref = unpack_outputs(eng.finish()), unpack_outputs(single.finish())
    assert np.isfinite(got["t_w_mo"]).all()
    np.testing.assert_allclose(got["t_w_lo"], ref["t_w_lo"], atol=1e-5)
    gap = np.linalg.norm(got["t_w_mo"] - ref["t_w_mo"], axis=1)
    jgap = np.linalg.norm(want["t_w_mo"] - jref["t_w_mo"], axis=1)
    print("MO mesh vs single, frame by frame (mm): port "
          f"{np.round(gap * 1e3, 3).tolist()}, reference "
          f"{np.round(jgap * 1e3, 3).tolist()}")
    assert gap.max() < 0.01 and jgap.max() < 0.01, (gap, jgap)
    np.testing.assert_allclose(got["t_w_lo"], want["t_w_lo"], atol=1e-3)
    np.testing.assert_allclose(got["t_w_mo"], want["t_w_mo"], atol=1e-2)
    active, cap = eng.window_active_rows
    assert 0 < active <= cap == 1024 == jeng.window_active_rows[1]
    assert abs(active - jeng.window_active_rows[0]) <= 0.01 * active


def test_mesh_vloam_engine_matches_jax_and_single(mesh, jmesh):
    from test_pipeline import synth_setup

    from vloam_tpu.vloam_step import VloamEngine as JVloamEngine
    from vloam_tpu.vloam_step import unpack_vloam_outputs as j_unpack_v
    from vloam_tpu_torch.vloam_step import VloamEngine, unpack_vloam_outputs

    calib, frames, _ = synth_setup(4, seed=3)
    cfg = _grid_cfg(1 << 15, 16, 16, detach_VO_LO=False)
    jeng = JVloamEngine(cfg, calib, chunk=2, mesh=jmesh, mesh_window_rows=1024)
    eng = VloamEngine(cfg, calib, chunk=2, mesh=mesh, mesh_window_rows=1024,
                      device="cpu")
    single = VloamEngine(cfg, calib, chunk=2, device="cpu")
    for f in frames():
        for e in (jeng, eng, single):
            e.push(f["points"], f["image"])
    want = j_unpack_v(jeng.finish(), calib)
    got = unpack_vloam_outputs(eng.finish(), calib)
    ref = unpack_vloam_outputs(single.finish(), calib)
    for which, tol, tol_j in (("VO", 1e-4, 2e-3), ("LO", 1e-4, 1e-3),
                              ("MO", 0.01, 1e-2)):
        t = got[f"traj_{which}"][:, :, 3]
        assert np.isfinite(t).all()
        d = np.linalg.norm(t - ref[f"traj_{which}"][:, :, 3], axis=1)
        assert d.max() < tol, (which, d)
        np.testing.assert_allclose(t, want[f"traj_{which}"][:, :, 3],
                                   atol=tol_j, err_msg=which)
    assert 0 < eng.window_active_rows[0] <= eng.window_active_rows[1]


def test_pose_graph_mesh_matches_unsharded(mesh, rng):
    from test_parallel import circle_poses, drifted_init

    from vloam_tpu.parallel import pose_graph as jpg
    from vloam_tpu_torch.parallel import pose_graph as tpg

    n = 24
    gt = circle_poses(n)
    init = drifted_init(gt, rng)

    def meas_fn(i, j):
        qi, qj = R.from_quat(gt[i, :4]), R.from_quat(gt[j, :4])
        return np.concatenate([(qi.inv() * qj).as_quat(),
                               qi.inv().apply(gt[j, 4:] - gt[i, 4:])])

    g = jpg.build_odometry_graph(init, loop_pairs=[(n - 1, 0)],
                                 meas_fn=meas_fn)
    want = np.asarray(jpg.optimize_pose_graph(g, gn_iters=4, cg_iters=64))
    whole = convert.split_pose_graph(g, 1, "cpu")[0]
    single = tpg.optimize_pose_graph(whole, gn_iters=4, cg_iters=64)
    sharded = tpg.optimize_pose_graph(tpg.shard_graph(whole, mesh), mesh=mesh,
                                      gn_iters=4, cg_iters=64)
    np.testing.assert_allclose(sharded[:, 4:], single[:, 4:], atol=2e-3)
    np.testing.assert_allclose(sharded.numpy()[:, 4:], want[:, 4:], atol=2e-3)


def test_close_loops_mesh_matches_jax(mesh, jmesh):
    """close_loops(mesh=) on the KITTI fixture's golden MO trajectory (as
    tests/test_torch_host_layer.py's close_loops test, 7 edges) against the
    JAX close_loops(mesh=)."""
    from test_torch_host_layer import FIXTURE, _fixture_mo_world, _pose_diff

    from vloam_tpu import config as jcfg
    from vloam_tpu.backend import loop_closure as jlc
    from vloam_tpu_torch import config as tcfg
    from vloam_tpu_torch.backend import loop_closure as tlc
    from vloam_tpu_torch.data import kitti as tk
    from vloam_tpu_torch.data.synthetic import pad_scan

    cfg_t = tcfg.tiny_test_profile()
    ds = tk.KittiOdometrySequence(str(FIXTURE), "00")
    q, t = _fixture_mo_world(ds.calib)

    def get_scan(k):
        return pad_scan(tk.load_velodyne_bin(ds.velo_files[k]),
                        cfg_t.lidar.max_points)

    kw = dict(radius=50.0, min_gap=1)
    want = jlc.close_loops(q, t, get_scan, jcfg.tiny_test_profile(),
                           mesh=jmesh, **kw)
    got = tlc.close_loops(q, t, get_scan, cfg_t, mesh=mesh, device="cpu",
                          **kw)
    assert got["loops"] == want["loops"] and len(got["loops"]) == 3
    dp, dr = _pose_diff(got["poses"], np.asarray(want["poses"]))
    assert dp < 1e-3 and dr < 1e-3, (dp, dr)


def test_mesh_checkpoint_is_refused(mesh, tmp_path):
    """A mesh with a checkpoint path raises, as the reference's
    run_sequence_fused (the map is sharded); the command line refuses it
    with an argparse error."""
    from vloam_tpu_torch.cli import main
    from vloam_tpu_torch.pipeline import run_sequence_fused

    cfg = small_cfg()
    calib = SimpleNamespace(imu_T_velo=np.eye(4), imu_T_cam0=np.eye(4))
    for kw in ({"save_state_path": str(tmp_path / "s.npz")},
               {"init_state": str(tmp_path / "s.npz")}):
        with pytest.raises(NotImplementedError, match="mesh"):
            run_sequence_fused(cfg, calib, [], lidar_only=True, mesh=mesh,
                               device="cpu", **kw)
    with pytest.raises(SystemExit) as e:
        main(["run", "--synthetic", "2", "--device", "cpu", "--mesh", "1",
              "--save-state", str(tmp_path / "s.npz")])
    assert e.value.code == 2


def test_mesh_state_split_and_join_round_trip():
    """convert.py: a MapState split into rank blocks joins back bit for
    bit (rank r holds rows [r nb/D, (r+1) nb/D)); a graph's edges split
    into rank shards padded with weight-0 edges."""
    from vloam_tpu.parallel import pose_graph as jpg
    from vloam_tpu.vloam_step import MapState as JMapState

    rng = np.random.default_rng(5)
    cfg = _grid_cfg(1 << 10, 16, 16)
    st = jax.tree.map(np.asarray, JMapState.create(cfg))
    pts = rng.normal(size=st.cube.corner.pts.shape).astype(np.float32)
    st = st._replace(cube=st.cube._replace(
        corner=st.cube.corner._replace(pts=pts)))
    for D in (1, 2, 4):
        parts = convert.split_map_state(st, D, "cpu")
        assert parts[1 % D].cube.corner.pts.shape[0] == (1 << 10) // D
        np.testing.assert_array_equal(
            parts[D - 1].cube.corner.pts.numpy(), pts[-(1 << 10) // D:])
        back = convert.join_map_states(parts)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(st)):
            np.testing.assert_array_equal(a, b)
    g = jpg.build_odometry_graph(np.tile([0, 0, 0, 1.0, 0, 0, 0], (6, 1)))
    shards = convert.split_pose_graph(g, 4, "cpu")
    assert [len(s.edge_i) for s in shards] == [2, 2, 2, 2]
    assert shards[2].weight.tolist() == [1.0, 0.0]
    assert shards[3].weight.tolist() == [0.0, 0.0]
    assert shards[3].meas[1].tolist() == [0, 0, 0, 1, 0, 0, 0]
