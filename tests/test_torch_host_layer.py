"""The port's host layer against the JAX package, on the CPU: the config's
host fields, the frame chain, map export and its publication cadence,
checkpoints across packages, the profiling helpers, the KITTI metrics, the
native IO library, the KITTI loader, the pose-graph solver and loop
closure.

Tolerances: every numpy module copied from the JAX package (frame chain,
KITTI metrics, the loaders, the native library's output) is bit-identical;
map export and checkpoints are bit-identical (same arrays, same keys, same
order); the pose graph within 1e-4 m and 1e-4 rad of the reference's (both
solve in float32; the port adds each node's terms in the reference's order,
its contractions sum in another); loop closure within 1e-3 m / 1e-3 rad of
the reference's on the fixture (the reference associates with quantized
distances, the port with exact ones) and with the same candidates and
accepted loops.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from vloam_tpu import config as jcfg
from vloam_tpu.data import synthetic as jsyn
from vloam_tpu_torch import config as tcfg

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# OpenMP pool stalls each small parallel CPU op when they are
# oversubscribed.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "kitti_mini"


# ------------------------------------------------------------------ config

def test_host_config_fields_equal_the_reference():
    """The fields the host layer reads, with the reference's names and
    defaults: sensor profiles, publication cadence, trajectory output."""
    for name in ("HDL64_KITTI", "HDL32", "VLP16"):
        got = dataclasses.asdict(getattr(tcfg, name))
        want = dataclasses.asdict(getattr(jcfg, name))
        assert got == {k: want[k] for k in got}, name
    t, j = tcfg.kitti_hdl64(), jcfg.kitti_hdl64()
    assert (t.save_traj, t.verbose_level, t.mapping.map_pub_number,
            t.lo.min_correspondences, t.lidar.name) == (
        j.save_traj, j.verbose_level, j.mapping.map_pub_number,
        j.lo.min_correspondences, j.lidar.name)
    assert tcfg.tiny_test_profile().lidar.name == "tiny"


# ------------------------------------------------------------- frame chain

def test_frame_chain_equals_the_reference(rng):
    from vloam_tpu.fusion import frame_chain as jfc
    from vloam_tpu_torch.fusion import frame_chain as tfc

    def rand_T():
        return jfc.make_T(R.from_rotvec(rng.normal(0, 0.3, 3)).as_matrix(),
                          rng.normal(0, 2.0, 3))

    imu_T_velo, imu_T_cam0 = rand_T(), rand_T()
    chains = [m.FrameChain(imu_T_velo, imu_T_cam0) for m in (jfc, tfc)]
    for count in range(6):
        cam_T = rand_T()
        q_f2f = R.from_rotvec(rng.normal(0, 0.05, 3)).as_quat()
        t_f2f, t_w, t_m = rng.normal(0, 1.0, (3, 3))
        q_w, q_m = R.from_rotvec(rng.normal(0, 0.5, (2, 3))).as_quat()
        got = []
        for c in chains:
            c.vo_update(cam_T)
            c.lo_update(q_f2f, t_f2f, q_w, t_w)
            c.mo_update(q_m, t_m)
            got.append([*c.lo_prior(), *c.vo_prior()]
                       + [c.to_cam0_start(w, count) for w in ("VO", "LO",
                                                             "MO")])
        for a, b in zip(*got):
            np.testing.assert_array_equal(a, b)
    for name in ("world_VOT_base_last", "base_T_cam0", "velo_T_cam0"):
        np.testing.assert_array_equal(getattr(chains[1], name),
                                      getattr(chains[0], name))
    T = rand_T()
    np.testing.assert_array_equal(tfc.inv(T), jfc.inv(T))
    q, t = R.random(random_state=3).as_quat(), rng.normal(size=3)
    np.testing.assert_array_equal(tfc.from_qt(q, t), jfc.from_qt(q, t))
    np.testing.assert_array_equal(tfc.base_T_cam0(imu_T_cam0),
                                  chains[0].base_T_cam0)

    class Buf(list):
        write = list.append

    lines = [Buf(), Buf()]
    for m, buf in zip((jfc, tfc), lines):
        m.write_kitti_pose_line(buf, T[:3])
    assert lines[0] == lines[1]


# ------------------------------------------------ map export and cadence

def _jax_map_state(rng, cfg):
    """A JAX LoamState whose grids hold points inserted by the jitted JAX
    grid_insert (both grids, live and evicted slots)."""
    from vloam_tpu.lidar import gridmap as jg
    from vloam_tpu.lidar.loam_step import LoamState

    st = LoamState.create(cfg)
    ins = jax.jit(jg.grid_insert, static_argnames=("cell", "res"))
    m = cfg.mapping
    grids = []
    for g, cell, res in ((st.cube.corner, m.corner_cell, m.line_resolution),
                         (st.cube.surf, m.surf_cell, m.plane_resolution)):
        for _ in range(2):
            p = rng.uniform(-40, 40, (1500, 3)).astype(np.float32)
            g = ins(g, jnp.asarray(p), jnp.ones(1500, bool), cell=cell,
                    res=res)
        g = jg.grid_evict(g, jnp.zeros(3), jnp.asarray([30.0, 30.0, 30.0]))
        grids.append(g)
    return st._replace(cube=st.cube._replace(corner=grids[0],
                                             surf=grids[1]))


def test_export_map_points_bit_identical_in_order(rng):
    from vloam_tpu.lidar.mapping import export_map_points as j_export
    from vloam_tpu_torch import convert
    from vloam_tpu_torch.lidar.mapping import export_map_points

    cfg = jcfg.tiny_test_profile()
    st = _jax_map_state(rng, cfg)
    tst = convert.loam_state_from_numpy(jax.tree.map(np.asarray, st), "cpu")
    for max_points in (1 << 20, 700):
        want = j_export(st.cube, max_points)
        got = export_map_points(tst.cube, max_points)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32 and len(w) > 500
            np.testing.assert_array_equal(g, w)


def _synthetic_frames(cfg, n, with_images):
    scene = jsyn.urban_scene(3)
    K, P, _, velo_T_cam = jsyn.default_cam_calib(cfg.vo.img_width,
                                                cfg.vo.img_height)
    calib = SimpleNamespace(K=K, P_velo_to_img=P @ np.linalg.inv(velo_T_cam),
                            imu_T_velo=np.eye(4), imu_T_cam0=velo_T_cam)
    frames = []
    for k, T in enumerate(jsyn.drive_trajectory(n, speed=0.8)):
        pts = jsyn.simulate_scan(scene, T, n_scans=cfg.lidar.n_scans,
                                 n_azimuth=360, seed=k)
        img = (jsyn.render_camera(scene, T @ velo_T_cam, K, cfg.vo.img_width,
                                  cfg.vo.img_height) if with_images else None)
        frames.append((pts, img))
    return calib, frames


@pytest.mark.parametrize("engine", ["LoamEngine", "VloamEngine"])
def test_map_publication_cadence(engine):
    """Both engines call map_callback every map_pub_number frames with the
    accumulated map, as tests/test_cli_kitti.py holds the reference's
    LoamEngine: [2, 4, 6] with map_pub_number=2 and chunk 2."""
    from vloam_tpu_torch.lidar.loam_step import LoamEngine
    from vloam_tpu_torch.vloam_step import VloamEngine

    cfg = tcfg.tiny_test_profile()
    cfg = cfg.replace(detach_VO_LO=False, mapping=dataclasses.replace(
        cfg.mapping, map_pub_number=2))
    calls = []

    def cb(frame_idx, corner, surf):
        calls.append((frame_idx, len(corner), len(surf)))

    calib, frames = _synthetic_frames(cfg, 6, engine == "VloamEngine")
    if engine == "LoamEngine":
        eng = LoamEngine(cfg, chunk=2, map_callback=cb, device="cpu")
        for pts, _ in frames:
            eng.push(pts)
    else:
        eng = VloamEngine(cfg, calib, chunk=2, map_callback=cb, device="cpu")
        for pts, img in frames:
            eng.push(pts, img)
    eng.finish()
    assert [c[0] for c in calls] == [2, 4, 6]
    assert calls[-1][2] > 100  # the surf map accumulated real points
    assert calls[0][2] <= calls[-1][2]


# ------------------------------------------------------------ checkpoints

def _fill(tree, rng):
    """The template's leaves replaced by random values of their dtypes."""
    def one(x):
        x = np.asarray(x)
        if x.dtype == bool:
            return rng.uniform(size=x.shape) < 0.5
        if np.issubdtype(x.dtype, np.integer):
            return rng.integers(-1000, 1000, x.shape).astype(x.dtype)
        return rng.normal(size=x.shape).astype(x.dtype)
    return jax.tree.map(one, tree)


def _pair_states(cfg):
    from vloam_tpu.vloam_step import MapState, VisionLoState
    from vloam_tpu_torch.vloam_step import MapState as TM
    from vloam_tpu_torch.vloam_step import VisionLoState as TV

    return ((VisionLoState.create(cfg), MapState.create(cfg)),
            (TV.create(cfg, "cpu"), TM.create(cfg, "cpu")))


def _loam_states(cfg):
    from vloam_tpu.lidar.loam_step import LoamState
    from vloam_tpu_torch.lidar.loam_step import LoamState as TL

    return LoamState.create(cfg), TL.create(cfg, "cpu")


@pytest.mark.parametrize("which", ["LoamState", "VloamEngine pair"])
def test_checkpoint_loads_across_packages(tmp_path, rng, which):
    """A checkpoint written by the JAX package loads into the port and one
    written by the port loads into the JAX package: the same keys (field
    paths, 0/ and 1/ for the pair), the same dtypes, bit-identical
    arrays."""
    from vloam_tpu.runtime import checkpoint as jck
    from vloam_tpu_torch.runtime import checkpoint as tck

    cfg = jcfg.tiny_test_profile()
    jtmpl, ttmpl = (_loam_states if which == "LoamState"
                    else _pair_states)(cfg)
    jstate = _fill(jtmpl, rng)
    jck.save_state(str(tmp_path / "j.npz"), jstate)
    got = tck.load_state(str(tmp_path / "j.npz"), ttmpl)
    assert type(got) is type(ttmpl)
    want = jax.tree_util.tree_leaves(jstate)
    leaves = list(tck._flatten(got).values())
    assert len(leaves) == len(want)
    for g, w in zip(leaves, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    tck.save_state(str(tmp_path / "t.npz"), got)
    back = jck.load_state(str(tmp_path / "t.npz"), jtmpl)
    for g, w in zip(jax.tree_util.tree_leaves(back), want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert set(a.files) == set(b.files)
        assert int(b["__format_version__"]) == 2
    if which != "LoamState":
        assert "0/vision/prev_grid/cnt" in a.files and "1/cube/center" in \
            a.files


def test_checkpoint_refuses_what_the_reference_refuses(tmp_path):
    from vloam_tpu_torch.lidar.loam_step import LoamState
    from vloam_tpu_torch.runtime import checkpoint as tck

    cfg = tcfg.tiny_test_profile()
    st = LoamState.create(cfg, "cpu")
    tck.save_state(str(tmp_path / "a.npz"), st)
    small = tcfg.tiny_test_profile().replace(mapping=dataclasses.replace(
        cfg.mapping, map_n_buckets=1 << 12))
    with pytest.raises(ValueError, match="shape mismatch for cube/corner"):
        tck.load_state(str(tmp_path / "a.npz"), LoamState.create(small, "cpu"))
    data = dict(np.load(tmp_path / "a.npz"))
    data["__format_version__"] = np.int32(1)
    np.savez(tmp_path / "v1.npz", **data)
    with pytest.raises(ValueError, match="format v1"):
        tck.load_state(str(tmp_path / "v1.npz"), st)
    del data["frame_idx"], data["__format_version__"]
    np.savez(tmp_path / "old.npz", **data)
    with pytest.raises(ValueError, match="format v1"):
        tck.load_state(str(tmp_path / "old.npz"), st)
    data["__format_version__"] = np.int32(2)
    np.savez(tmp_path / "missing.npz", **data)
    with pytest.raises(KeyError, match="frame_idx"):
        tck.load_state(str(tmp_path / "missing.npz"), st)


# -------------------------------------------------------------- profiling

def test_profiling_helpers(tmp_path):
    from vloam_tpu.runtime import profiling as jprof
    from vloam_tpu_torch.runtime import profiling as tprof

    stats = [{"t_a": float(k), "t_b": 2.0 * k} for k in range(7)]
    stats[3]["t_c"] = 5.0
    assert tprof.summarize_timings(stats) == jprof.summarize_timings(stats)
    assert tprof.summarize_timings(stats[:3]) == \
        jprof.summarize_timings(stats[:3])
    assert tprof.summarize_timings([]) == {}
    dog = tprof.Watchdog(budget_ms=10.0)
    assert [dog.check(x) for x in (5.0, 11.0, 10.0)] == [False, True, False]
    assert (dog.frames, dog.overruns) == (3, 1)
    t = tprof.TicToc()
    assert t.toc_ms() >= 0.0
    x = torch.ones(4)
    tprof.fence((x, (x,)))  # CPU leaves: nothing to wait for
    with tprof.device_trace(str(tmp_path / "trace")):
        (x * 2).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


# ----------------------------------------------------------- KITTI metrics

def test_kitti_metrics_equal_the_reference(tmp_path, rng):
    from vloam_tpu.eval import kitti_metrics as jm
    from vloam_tpu_torch.eval import kitti_metrics as tm

    gt = tm.load_kitti_poses(FIXTURE / "poses_00.txt")
    np.testing.assert_array_equal(gt, jm.load_kitti_poses(
        FIXTURE / "poses_00.txt"))
    pert = gt.copy()
    pert[:, :3, 3] += rng.normal(0, 0.05, (len(gt), 3))
    pert[:, :3, :3] = np.einsum(
        "nij,njk->nik", R.from_rotvec(rng.normal(0, 0.01, (len(gt), 3)))
        .as_matrix(), gt[:, :3, :3])
    # a 250-pose arc, long enough for the 100-800 m subsequences
    long_gt = np.stack(jsyn.drive_trajectory(250, speed=1.5,
                                             yaw_rate=0.004))
    long_pred = long_gt.copy()
    long_pred[:, :3, 3] += np.cumsum(rng.normal(0, 0.02, (250, 3)), axis=0)
    for g, p in ((gt, gt), (gt, pert), (gt[:, :3], pert[:, :3]),
                 (long_gt, long_pred)):
        for step in (1, 10):
            want = jm.kitti_metrics(g, p, step=step)
            got = tm.kitti_metrics(g, p, step=step)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.isfinite(tm.kitti_metrics(long_gt, long_pred)["t_rel_percent"])


# ---------------------------------------------------- native IO and KITTI

def _velo_files():
    return sorted((FIXTURE / "sequences" / "00" / "velodyne").glob("*.bin"))


def test_native_io_equals_the_reference():
    """The port's copy of the native library builds under its own
    directory (one that .gitignore lists) and reads the fixture's scans
    and projects them to range images bit for bit as the reference's."""
    from vloam_tpu.runtime import native_io as jn
    from vloam_tpu_torch.runtime import native_io as tn

    assert tn.available()
    assert tn._SO.parent == REPO / "vloam_tpu_torch" / "runtime" / "native" \
        / "build"
    # .gitignore's build/ pattern covers the library
    assert "build/" in (REPO / ".gitignore").read_text().split()
    for f in _velo_files():
        np.testing.assert_array_equal(tn.load_bin_native(str(f)),
                                      jn.load_bin_native(str(f)))
        for scans in (16, 64):
            np.testing.assert_array_equal(
                tn.project_polar_native(str(f), scans, 1800),
                jn.project_polar_native(str(f), scans, 1800))
    paths = [str(f) for f in _velo_files()]
    got = [(a.copy(), n) for a, n in tn.PrefetchLoader(paths, 8192)]
    want = [(a.copy(), n) for a, n in jn.PrefetchLoader(paths, 8192)]
    for (a, n), (b, m) in zip(got, want, strict=True):
        assert n == m
        np.testing.assert_array_equal(a, b)
    got = [a.copy() for a, _ in tn.PolarPrefetchLoader(paths, 16, 900)]
    want = [a.copy() for a, _ in jn.PolarPrefetchLoader(paths, 16, 900)]
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("polar", [False, True])
def test_kitti_loader_equals_the_reference(polar):
    from vloam_tpu.data import kitti as jk
    from vloam_tpu_torch.data import kitti as tk

    kw = dict(polar_ingest=polar, polar_scans=16)
    t = tk.KittiOdometrySequence(str(FIXTURE), "00", **kw)
    j = jk.KittiOdometrySequence(str(FIXTURE), "00", **kw)
    assert len(t) == len(j) == 5
    for name in ("P_rect0", "cam_T_velo", "rect0_T_cam", "imu_T_velo",
                 "imu_T_cam0", "K", "P_velo_to_img", "velo_T_cam0"):
        np.testing.assert_array_equal(getattr(t.calib, name),
                                      getattr(j.calib, name), err_msg=name)
    for i in range(len(t)):
        a, b = t.frame(i), j.frame(i)
        assert a.keys() == b.keys() == {"polar" if polar else "points",
                                        "image"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    f = _velo_files()[0]
    np.testing.assert_array_equal(tk.load_velodyne_bin(f),
                                  jk.load_velodyne_bin(f))


def test_raw_drive_loader_equals_the_reference(tmp_path):
    """A KITTI raw layout built from the fixture's files: the raw calib
    parser (cam_to_cam, velo_to_cam, imu_to_velo) and the drive's frames."""
    import shutil

    from vloam_tpu.data import kitti as jk
    from vloam_tpu_torch.data import kitti as tk

    date = tmp_path / "2011_09_26"
    drive = date / "2011_09_26_drive_0001_sync"
    (drive / "velodyne_points" / "data").mkdir(parents=True)
    (drive / "image_00" / "data").mkdir(parents=True)
    seq = FIXTURE / "sequences" / "00"
    for k, f in enumerate(_velo_files()[:2]):
        shutil.copy(f, drive / "velodyne_points" / "data" / f"{k:010d}.bin")
        shutil.copy(seq / "image_0" / f"{k:06d}.png",
                    drive / "image_00" / "data" / f"{k:010d}.png")
    rect = R.from_rotvec([0.01, -0.02, 0.005]).as_matrix()
    (date / "calib_cam_to_cam.txt").write_text(
        "calib_time: 09-Jan-2012\n"
        f"R_rect_00: {' '.join(map(str, rect.ravel()))}\n"
        "P_rect_00: 718.9 0 607.2 0 0 718.9 185.2 0 0 0 1 0\n")
    (date / "calib_velo_to_cam.txt").write_text(
        "R: 0 -1 0 0 0 -1 1 0 0\nT: -0.004 -0.076 -0.271\n")
    (date / "calib_imu_to_velo.txt").write_text(
        "R: 1 0.0007 -0.001 -0.0008 1 -0.008 0.001 0.008 1\n"
        "T: -0.81 0.32 -0.8\n")
    t = tk.KittiRawDrive(str(tmp_path), "2011_09_26", "0001")
    j = jk.KittiRawDrive(str(tmp_path), "2011_09_26", "0001")
    assert len(t) == len(j) == 2
    for name in ("P_rect0", "cam_T_velo", "rect0_T_cam", "imu_T_velo",
                 "imu_T_cam0", "P_velo_to_img", "velo_T_cam0"):
        np.testing.assert_array_equal(getattr(t.calib, name),
                                      getattr(j.calib, name), err_msg=name)
    for i in range(2):
        a, b = t.frame(i), j.frame(i)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------- pose graph

def _chain_with_loops(seed=7, n=40):
    """A random 40-pose drive, its odometry disturbed, and 3 loop edges
    measured from the true poses."""
    rng = np.random.default_rng(seed)
    yaw = np.cumsum(rng.normal(0, 0.08, n))
    q = R.from_euler("zyx", np.stack(
        [yaw, rng.normal(0, 0.02, n), rng.normal(0, 0.02, n)], 1)).as_quat()
    t = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw),
                            rng.normal(0, 0.05, n)], 1), axis=0)
    truth = np.concatenate([q, t], axis=1)
    noisy = truth.copy()
    noisy[:, 4:] += rng.normal(0, 0.05, (n, 3))
    noisy[:, :4] = (R.from_quat(q)
                    * R.from_rotvec(rng.normal(0, 0.01, (n, 3)))).as_quat()
    loops = [(0, 30), (6, 35), (12, n - 1)]

    def meas_fn(i, j):
        qi, qj = R.from_quat(truth[i, :4]), R.from_quat(truth[j, :4])
        return np.concatenate([(qi.inv() * qj).as_quat(),
                               qi.inv().apply(truth[j, 4:] - truth[i, 4:])])

    return truth, noisy, loops, meas_fn


def _pose_diff(a, b):
    return (float(np.abs(a[:, 4:] - b[:, 4:]).max()),
            float((R.from_quat(a[:, :4]).inv()
                   * R.from_quat(b[:, :4])).magnitude().max()))


def test_pose_graph_matches_the_reference():
    """A 40-pose chain with 3 loop edges through both solvers: positions
    within 1e-4 m, rotations within 1e-4 rad of the reference's."""
    from vloam_tpu.parallel import pose_graph as jpg
    from vloam_tpu_torch.parallel import pose_graph as tpg

    _, noisy, loops, meas_fn = _chain_with_loops()
    kw = dict(loop_weight=3.0, meas_fn=meas_fn)
    gj = jpg.build_odometry_graph(noisy, loops, **kw)
    gt = tpg.build_odometry_graph(noisy, loops, device="cpu", **kw)
    for a, b in zip(gt, gj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = np.asarray(jpg.optimize_pose_graph(gj, gn_iters=6, cg_iters=120))
    got = tpg.optimize_pose_graph(gt, gn_iters=6, cg_iters=120)
    assert got.dtype == torch.float32 and got.shape == (40, 7)
    dp, dr = _pose_diff(got.numpy(), want)
    assert dp < 1e-4 and dr < 1e-4, (dp, dr)
    # the optimized poses satisfy the loop measurements better
    def loop_err(p):
        return max(np.linalg.norm(
            R.from_quat(p[i, :4]).inv().apply(p[j, 4:] - p[i, 4:])
            - meas_fn(i, j)[4:]) for i, j in loops)
    assert loop_err(got.numpy()) < 0.5 * loop_err(noisy)
    # the same result on a second run: every node sum adds in one order
    again = tpg.optimize_pose_graph(gt, gn_iters=6, cg_iters=120)
    assert torch.equal(got, again)
    # edge-sharded over a one-rank mesh: the same sums, the same poses
    from vloam_tpu_torch.parallel.sharded import data_mesh

    mesh = data_mesh(device="cpu")
    assert torch.equal(tpg.optimize_pose_graph(
        tpg.shard_graph(gt, mesh), mesh=mesh, gn_iters=6, cg_iters=120), got)


def test_pose_graph_jacobian_matches_float64_jacfwd(rng):
    """The per-edge Jacobian (forward mode in float32) against the same
    residual differentiated in float64."""
    from vloam_tpu_torch.parallel import pose_graph as tpg

    _, noisy, _, meas_fn = _chain_with_loops(seed=3, n=12)
    g = tpg.build_odometry_graph(noisy, [(0, 11)], meas_fn=meas_fn,
                                 device="cpu")
    r, J = tpg._edge_terms(g.poses, g.edge_i, g.edge_j, g.meas, g.weight)
    r64, J64 = tpg._edge_terms(g.poses.double(), g.edge_i, g.edge_j,
                               g.meas.double(), g.weight.double())
    np.testing.assert_allclose(r.numpy(), r64.numpy(), atol=1e-5)
    np.testing.assert_allclose(J.numpy(), J64.numpy(), atol=1e-5)


# ----------------------------------------------------------- loop closure

def test_loop_candidates_equal_the_reference(rng):
    from vloam_tpu.backend import loop_closure as jlc
    from vloam_tpu_torch.backend import loop_closure as tlc

    pos = np.cumsum(rng.normal(0, 1.0, (300, 3)), axis=0)
    pos[200:240] = pos[20:60] + rng.normal(0, 0.5, (40, 3))
    for radius, gap, cap in ((10.0, 50, 10), (3.0, 20, 2), (50.0, 1, 10)):
        assert tlc.find_loop_candidates(pos, radius, gap, cap) == \
            jlc.find_loop_candidates(pos, radius, gap, cap)


def _fixture_mo_world(calib):
    """The fixture's golden MO trajectory as world (q, t) of the base."""
    from vloam_tpu_torch.fusion.frame_chain import FrameChain

    mo = np.loadtxt(FIXTURE / "golden" / "MO1.txt").reshape(-1, 3, 4)
    B = FrameChain(np.asarray(calib.imu_T_velo, np.float64),
                   np.asarray(calib.imu_T_cam0, np.float64)).base_T_cam0
    X = np.concatenate([mo, np.broadcast_to([[[0.0, 0, 0, 1]]],
                                            (len(mo), 1, 4))], axis=1)
    W = np.einsum("ij,njk,kl->nil", B, X, np.linalg.inv(B))
    return R.from_matrix(W[:, :3, :3]).as_quat(), W[:, :3, 3]


def test_close_loops_matches_the_reference_on_the_fixture():
    """The fixture's 5 frames with min_gap=1, radius=50 (as
    tests/test_cli_kitti.py's --loop-close run): the same candidates, the
    same accepted loops, poses within 1e-3 m / 1e-3 rad of the reference's
    and within 1 m of the input trajectory."""
    from vloam_tpu.backend import loop_closure as jlc
    from vloam_tpu_torch.backend import loop_closure as tlc
    from vloam_tpu_torch.data import kitti as tk
    from vloam_tpu_torch.data.synthetic import pad_scan

    cfg_j, cfg_t = jcfg.tiny_test_profile(), tcfg.tiny_test_profile()
    ds = tk.KittiOdometrySequence(str(FIXTURE), "00")
    q, t = _fixture_mo_world(ds.calib)

    def get_scan(k):
        return pad_scan(tk.load_velodyne_bin(ds.velo_files[k]),
                        cfg_t.lidar.max_points)

    kw = dict(radius=50.0, min_gap=1)
    assert tlc.find_loop_candidates(t, 50.0, 1) == \
        jlc.find_loop_candidates(t, 50.0, 1) == [(2, 0), (3, 1), (4, 2)]
    want = jlc.close_loops(q, t, get_scan, cfg_j, **kw)
    got = tlc.close_loops(q, t, get_scan, cfg_t, device="cpu", **kw)
    assert got["loops"] == want["loops"] and len(want["loops"]) == 3
    dp, dr = _pose_diff(got["poses"], np.asarray(want["poses"]))
    assert dp < 1e-3 and dr < 1e-3, (dp, dr)
    assert np.abs(got["poses"][:, 4:] - t).max() < 1.0
    # each accepted pair's match itself, against the reference's
    from vloam_tpu_torch.fusion.frame_chain import from_qt
    i, j = want["loops"][0]
    T_init = np.linalg.inv(from_qt(q[j], t[j])) @ from_qt(q[i], t[i])
    qj, tj, nj = jlc.match_pair(*get_scan(i), *get_scan(j), T_init, cfg_j)
    qt_, tt, nt = tlc.match_pair(*get_scan(i), *get_scan(j), T_init, cfg_t,
                                 device="cpu")
    assert abs(nt - nj) <= max(5, nj // 20) and nt >= 100
    np.testing.assert_allclose(tt, tj, atol=1e-3)
    assert (R.from_quat(qt_).inv() * R.from_quat(qj)).magnitude() < 1e-3


# ------------------------------------------------------------ the entries

def test_entry_points_default_to_the_card():
    """Without a card, every new entry point refuses the default device
    and runs when the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    from vloam_tpu_torch.backend import loop_closure as tlc
    from vloam_tpu_torch.pipeline import run_sequence_fused

    cfg = tcfg.tiny_test_profile()
    calib = SimpleNamespace(imu_T_velo=np.eye(4), imu_T_cam0=np.eye(4))
    with pytest.raises(RuntimeError, match="is_available"):
        run_sequence_fused(cfg, calib, [], lidar_only=True)
    with pytest.raises(RuntimeError, match="is_available"):
        tlc.match_pair(np.zeros((8, 3), np.float32), 0,
                       np.zeros((8, 3), np.float32), 0, np.eye(4), cfg)
    # a mesh runs on its own device (a CPU mesh with the card asked for is
    # refused) and refuses checkpoints, as the reference's
    from vloam_tpu_torch.parallel.sharded import data_mesh

    mesh = data_mesh(device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        run_sequence_fused(cfg, calib, [], lidar_only=True, mesh=mesh)
    with pytest.raises(NotImplementedError, match="mesh"):
        run_sequence_fused(cfg, calib, [], lidar_only=True, mesh=mesh,
                           save_state_path="unused.npz", device="cpu")
    out = run_sequence_fused(cfg, calib, [], lidar_only=True, device="cpu")
    assert out["LO"].shape == (0, 3, 4)
    # the host engine and its stages
    from vloam_tpu_torch.lidar.mapping import LaserMapping
    from vloam_tpu_torch.lidar.odometry import LaserOdometry
    from vloam_tpu_torch.pipeline import VloamPipeline, run_sequence
    from vloam_tpu_torch.vision.vo import VisualOdometry

    calib.K = np.diag([100.0, 100.0, 1.0])
    calib.P_velo_to_img = np.eye(3, 4)
    for make in (lambda **kw: run_sequence(cfg, calib, [], **kw),
                 lambda **kw: VloamPipeline(cfg, calib, **kw),
                 lambda **kw: LaserOdometry(cfg.lo, **kw),
                 lambda **kw: LaserMapping(cfg.mapping, **kw),
                 lambda **kw: VisualOdometry(cfg.vo, calib.K,
                                             calib.P_velo_to_img, **kw)):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
        assert make(device="cpu") is not None
    proc = subprocess.run(
        [sys.executable, "-m", "vloam_tpu_torch", "run", "--synthetic", "2",
         "--sensor", "tiny"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 2 and "--device cpu" in proc.stderr
    # the accuracy evaluations refuse before they make a frame
    from vloam_tpu_torch.tools import (eval_highway, eval_long,
                                       eval_loop_closure, eval_synthetic)

    for tool in (eval_synthetic, eval_long, eval_loop_closure, eval_highway):
        with pytest.raises(RuntimeError, match="is_available"):
            tool.main(["--frames", "2"])


def test_port_host_modules_never_import_jax():
    code = ("import sys, vloam_tpu_torch.cli, vloam_tpu_torch.pipeline, "
            "vloam_tpu_torch.runtime.checkpoint, "
            "vloam_tpu_torch.runtime.profiling, "
            "vloam_tpu_torch.runtime.native_io, vloam_tpu_torch.data.kitti, "
            "vloam_tpu_torch.eval.kitti_metrics, "
            "vloam_tpu_torch.backend.loop_closure, "
            "vloam_tpu_torch.parallel.pose_graph, "
            "vloam_tpu_torch.lidar.odometry, vloam_tpu_torch.lidar.mapping, "
            "vloam_tpu_torch.vision.vo, vloam_tpu_torch.vision.viz, "
            "vloam_tpu_torch.vision.optical_flow; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vloam_tpu', 'PIL')); assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
