"""The port's distributed paths as real ranks: D = 2 and 4 gloo processes
on the CPU, started by vloam_tpu_torch.parallel.launch (one process a rank,
tests/torch_mesh_worker.py), against the JAX package on a D-device mesh of
conftest's virtual CPU devices. Rank r of the port holds what JAX device r
holds: the same shard_batch blocks, map rows and edge shards.

- sharded_map_alignment on tests/test_sharded_mapping.py's structured world:
  the pose within 0.02 m / 5e-3 rad of the reference's (see
  tests/test_torch_mesh.py for why no tighter bound holds against it), the
  ranks' accepted counts summing to the port's one-rank count exactly,
  each 95% of its block's residuals or more (the port's float64 plane fit,
  F5) and together at least the reference's; the pose within 1e-4 of the
  port's one-rank run.
- LoamEngine(mesh=) over a 6-frame drive (2^15 buckets, 512 window rows a
  rank) against the JAX mesh engine: LO 1e-3 m, MO 1e-2 m (the bounds of the
  port against the JAX engines elsewhere), the peak active rows within 1%
  (MO within 1e-2 m moves a point into another bucket now and then).
- the edge-sharded pose graph against the JAX sharded solve and the port's
  unsharded one: within 2e-3 (tests/test_parallel.py's bound).
- python -m vloam_tpu_torch run --device cpu --mesh D on the KITTI fixture:
  5 finite MO poses.

Every case runs under its own wall-clock limit (LIMIT_S), after which all
its processes are killed; the ranks' collectives give up after
tests/torch_mesh_worker.py's COLLECTIVE_S, before the limit, so a hang is
reported by the rank that waits. A failed case reports each rank's exit
code (124: the limit) and the end of its stderr. The limit guards against
hangs and checks no result: it is 4x what the slowest case's ranks take
with one core between them (the engine at 4 ranks: 89.9 s, each rank
registering and associating all 6 frames on the CPU's plain kernels), so
the ranks may run on a quarter of a core under the suite's -n 6 load. At
110 s, 1.2x the one-core time, that case failed under a loaded run of the
suite. Every rank ends its process group through sharded.spmd_mesh before
it exits (tests/test_torch_mesh_teardown.py): ranks that left theirs to
interpreter exit aborted now and then after their work was done.

- launch() itself: a rank that fails is reported with its code and
  stderr, the others killed; the ranks join the launcher's store, so
  launches started together never race for a port.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from vloam_tpu.parallel import sharded as jsh
from vloam_tpu_torch.parallel import sharded as tsh
from vloam_tpu_torch.parallel.launch import launch

from test_pipeline import small_cfg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("torch_mesh_worker.py")
FIXTURE = REPO / "tests" / "fixtures" / "kitti_mini"
LIMIT_S = 360
SIZES = [2, 4]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _ranks(case: str, D: int, inputs: dict, tmp_path) -> dict:
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, **inputs)
    run = launch([str(WORKER), case, str(inp), str(out)], D, timeout=LIMIT_S,
                 env=_env())
    assert run.code == 0, (f"{case} at {D} ranks exited {run.code} (124: "
                           f"past {LIMIT_S} s)\n{run.report()}")
    return dict(np.load(out))


def test_launch_reports_each_rank(tmp_path):
    """A rank that fails ends the run with its code; the report names each
    rank's code and the end of its stderr. Three launches at once, each a
    2-rank gloo group that all-reduces, all pass: each group's store is its
    own launcher's."""
    from concurrent.futures import ThreadPoolExecutor

    script = tmp_path / "rank.py"
    script.write_text(
        "import os, sys, torch, torch.distributed as dist\n"
        "dist.init_process_group('gloo', init_method='env://')\n"
        "x = torch.ones(1)\n"
        "dist.all_reduce(x)\n"
        "assert x.item() == dist.get_world_size()\n"
        "dist.destroy_process_group()\n"
        "if sys.argv[1] == 'fail' and os.environ['RANK'] == '1':\n"
        "    sys.stderr.write('rank one gives up\\n')\n"
        "    sys.exit(3)\n")
    run = launch([str(script), "fail"], 2, timeout=LIMIT_S, env=_env())
    assert run.code == 3 and run.codes[1] == 3
    assert "rank one gives up" in run.tails[1]
    assert "rank 1 exited 3" in run.report()
    with ThreadPoolExecutor(3) as pool:
        runs = list(pool.map(lambda _: launch([str(script), "pass"], 2,
                                              timeout=LIMIT_S, env=_env()),
                             range(3)))
    assert [r.code for r in runs] == [0, 0, 0], [r.report() for r in runs]


@pytest.mark.parametrize("D", SIZES)
def test_sharded_map_alignment_ranks(D, tmp_path):
    from test_sharded_mapping import _problem, _run

    from vloam_tpu_torch.parallel.sharded_mapping import sharded_map_alignment

    cfg, mc, ms, cs, ss, _, _ = _problem(np.random.default_rng(16833))
    xj, cj = _run(jsh.data_mesh(jax.devices()[:D]), cfg, mc, ms, cs, ss)
    f32 = {k: np.asarray(v, np.float32) for k, v in (
        ("c_stack", cs), ("s_stack", ss), ("map_corner", mc),
        ("map_surf", ms))}
    x0 = np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32)
    got = _ranks("alignment", D, dict(f32, x0=x0), tmp_path)
    # the same function at one rank, in this process
    mesh = tsh.data_mesh(device="cpu")
    args = []
    for k in ("c_stack", "s_stack", "map_corner", "map_surf"):
        args += [torch.from_numpy(f32[k]),
                 torch.ones(len(f32[k]), dtype=torch.bool)]
    x1, c1 = sharded_map_alignment(mesh, *args, torch.from_numpy(x0), cfg,
                                   return_counts=True)
    x, counts = got["x"].astype(np.float64), got["counts"]
    assert counts.shape == (D,) and counts.sum() == float(c1[0])
    np.testing.assert_allclose(x, x1.numpy(), atol=1e-4)
    xj, cj = np.asarray(xj, np.float64), np.asarray(cj)
    np.testing.assert_allclose(x[4:], xj[4:], atol=0.02)
    assert (R.from_quat(x[:4]).inv() * R.from_quat(xj[:4])).magnitude() \
        < 5e-3
    # each rank accepts nearly all of its block's residuals (the port's
    # float64 plane fit, F5; the reference's float32 fit loses about half of
    # them) and, over the ranks, at least what the reference accepts
    per_rank = (len(cs) + len(ss)) / D
    assert (counts >= 0.95 * per_rank).all() and counts.sum() >= cj.sum(), (
        counts, cj)


@pytest.mark.parametrize("D", SIZES)
def test_mesh_loam_engine_ranks(D, tmp_path):
    import dataclasses

    from vloam_tpu.data import synthetic
    from vloam_tpu.lidar.loam_step import LoamEngine, unpack_outputs

    nb, cap_c, cap_s, window = 1 << 15, 16, 16, 512
    cfg = small_cfg()
    cfg = cfg.replace(mapping=dataclasses.replace(
        cfg.mapping, map_n_buckets=nb, corner_bucket_cap=cap_c,
        surf_bucket_cap=cap_s))
    scene = synthetic.urban_scene(11)
    poses = synthetic.drive_trajectory(6, speed=1.0, yaw_rate=0.02)
    scans = [synthetic.simulate_scan(scene, T, n_scans=64, n_azimuth=700,
                                     seed=1100 + k)
             for k, T in enumerate(poses)]
    jeng = LoamEngine(cfg, chunk=3, mesh=jsh.data_mesh(jax.devices()[:D]),
                      mesh_window_rows=window)
    for s in scans:
        jeng.push(s)
    want = unpack_outputs(jeng.finish())
    got = _ranks("engine", D, {
        "grid": np.asarray([nb, cap_c, cap_s, window]),
        "n_frames": np.asarray(len(scans)),
        **{f"scan_{k}": s for k, s in enumerate(scans)}}, tmp_path)
    res = unpack_outputs(got["rows"])
    assert np.isfinite(got["rows"]).all() and len(got["rows"]) == 6
    np.testing.assert_allclose(res["t_w_lo"], want["t_w_lo"], atol=1e-3)
    np.testing.assert_allclose(res["t_w_mo"], want["t_w_mo"], atol=1e-2)
    active, cap = got["window"]
    assert 0 < active <= cap == window * D == jeng.window_active_rows[1]
    # MO within 1e-2 m moves a point into another bucket now and then
    assert abs(active - jeng.window_active_rows[0]) <= 0.01 * active


@pytest.mark.parametrize("D", SIZES)
def test_pose_graph_ranks(D, tmp_path):
    from test_parallel import circle_poses, drifted_init

    from vloam_tpu.parallel import pose_graph as jpg
    from vloam_tpu_torch import convert
    from vloam_tpu_torch.parallel import pose_graph as tpg

    n = 24
    gt = circle_poses(n)
    init = drifted_init(gt, np.random.default_rng(16833))

    def meas_fn(i, j):
        qi, qj = R.from_quat(gt[i, :4]), R.from_quat(gt[j, :4])
        return np.concatenate([(qi.inv() * qj).as_quat(),
                               qi.inv().apply(gt[j, 4:] - gt[i, 4:])])

    g = jpg.build_odometry_graph(init, loop_pairs=[(n - 1, 0), (n // 2, 0)],
                                 meas_fn=meas_fn)
    jmesh = jsh.data_mesh(jax.devices()[:D])
    gp = jpg.PoseGraph(g.poses, *(jsh.shard_batch(a, jmesh) for a in (
        g.edge_i, g.edge_j, g.meas, g.weight)))
    want = np.asarray(jpg.optimize_pose_graph(gp, mesh=jmesh, gn_iters=4,
                                              cg_iters=64))
    single = tpg.optimize_pose_graph(convert.split_pose_graph(g, 1, "cpu")[0],
                                     gn_iters=4, cg_iters=64).numpy()
    got = _ranks("pose_graph", D, {k: np.asarray(getattr(g, k)) for k in (
        "poses", "edge_i", "edge_j", "meas", "weight")}, tmp_path)["poses"]
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], atol=2e-3)
    np.testing.assert_allclose(got[:, 4:], single[:, 4:], atol=2e-3)


@pytest.mark.parametrize("D", SIZES)
def test_cli_mesh_ranks(D, tmp_path):
    out = tmp_path / "out"
    proc = subprocess.Popen(
        [sys.executable, "-m", "vloam_tpu_torch", "run", "--odometry-root",
         str(FIXTURE), "--seq", "00", "--sensor", "tiny", "--mode",
         "lidar-only", "--chunk", "2", "--device", "cpu", "--verbose", "0",
         "--out", str(out), "--mesh", str(D)],
        env=_env(), start_new_session=True)
    try:
        rc = proc.wait(timeout=LIMIT_S)
    finally:  # the launcher and its ranks are one process group
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert rc == 0
    mo = np.loadtxt(out / "MO1.txt").reshape(-1, 3, 4)
    assert len(mo) == 5 and np.isfinite(mo).all()
