"""How the port's SPMD programs end their process groups.

Every SPMD entry point (tests/torch_mesh_worker.py's main, the command
line's --mesh run, tools/bench_mesh.py, tools/model_mesh_scaling.py,
tools/trajectories.py, chip_smoke.py's mesh phases) holds its group through
parallel.sharded.spmd_mesh, which ends a group it started: a barrier and
destroy_process_group() after a normal exit, destroy_process_group() alone
after an exception. Here:

- the worker's main and cli.main(... --mesh 1 --device cpu) run in a fresh
  process at a world of one rank, once to the end and once with an error
  raised inside the run: the group is live during the run and gone after
  it with its gloo threads, and the error reaches the caller;
- a group that existed before spmd_mesh is left as it was, and a Mesh of
  the default group holds no reference to it;
- a 2-rank gloo all-reduce that ends through spmd_mesh at module level,
  launched 10 times: every launch exits 0, no rank's stderr says
  "terminate called", no gloo thread outlives the block;
- a --mesh run whose ranks fail names each rank's exit code and stderr;
- launch.rank_env shares out the cores the launcher may run on (its
  affinity), not the host's count, and turns faulthandler on in the ranks.

A rank whose gloo threads live on to interpreter exit can abort after its
work is done ("terminate called without an active exception": a worker
that frees a finished collective's tensors there must take the GIL, and
Python 3.12 ends it with pthread_exit), as test_torch_mesh_multiprocess.py's
cases did under a loaded suite. So the entry points' processes and the
launched ranks also check that no gloo thread is left once the group has
ended, though their Mesh lives on.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from vloam_tpu_torch.parallel import sharded
from vloam_tpu_torch.parallel.launch import launch

from test_parallel import circle_poses

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TESTS = REPO / "tests"
FIXTURE = TESTS / "fixtures" / "kitti_mini"
LIMIT_S = 360  # tests/test_torch_mesh_multiprocess.py's guard against hangs

# The names of this process's gloo threads (its TCP loop and the group's
# workers), which must be gone once a program has ended its group.
GLOO_THREADS = """
import os


def gloo_threads():
    names = []
    for t in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{t}/comm") as f:
                names.append(f.read().strip())
        except FileNotFoundError:  # a thread that ended meanwhile
            pass
    return sorted(n for n in names if "gloo" in n)
"""

# Runs one entry point in a fresh process; the patched function is called
# inside the run and records whether the group is live there.
ENTRY = GLOO_THREADS + """
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)
entry, fails, tmp = sys.argv[1], sys.argv[2] == "1", sys.argv[3]
live = []


def inside(fn):
    def run(*args, **kw):
        live.append(dist.is_initialized())
        if fails:
            raise RuntimeError("raised inside the run")
        return fn(*args, **kw)
    return run


if entry == "worker":
    import torch_mesh_worker as worker

    worker.pose_graph = inside(worker.pose_graph)
    go = lambda: worker.main("pose_graph", tmp + "/in.npz", tmp + "/out.npz")
else:
    from vloam_tpu_torch import cli, pipeline

    pipeline.run_sequence_fused = inside(pipeline.run_sequence_fused)
    go = lambda: cli.main(["run", "--odometry-root", sys.argv[4], "--seq",
                           "00", "--sensor", "tiny", "--mode", "lidar-only",
                           "--chunk", "2", "--device", "cpu", "--verbose",
                           "0", "--out", tmp + "/out", "--mesh", "1"])
try:
    go()
except RuntimeError as e:
    assert fails and "raised inside the run" in str(e), e
else:
    assert not fails
print("LIVE", live, "AFTER", dist.is_initialized(), "GLOO", gloo_threads())
"""


def _env():
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
        "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), str(TESTS)]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _graph_inputs() -> dict:
    from vloam_tpu_torch.parallel.pose_graph import build_odometry_graph

    g = build_odometry_graph(circle_poses(8), loop_pairs=[(7, 0)],
                             device="cpu")
    return {k: np.asarray(getattr(g, k)) for k in (
        "poses", "edge_i", "edge_j", "meas", "weight")}


@pytest.mark.parametrize("fails", [False, True], ids=["ends", "raises"])
@pytest.mark.parametrize("entry", ["worker", "cli"])
def test_entry_point_ends_its_group(entry, fails, tmp_path):
    if entry == "worker":
        np.savez(tmp_path / "in.npz", **_graph_inputs())
    proc = subprocess.run(
        [sys.executable, "-c", ENTRY, entry, str(int(fails)), str(tmp_path),
         str(FIXTURE)], env=_env(), capture_output=True, text=True,
        timeout=LIMIT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LIVE [True] AFTER False GLOO []" in proc.stdout, (
        proc.stdout, proc.stderr[-4000:])
    wrote = (tmp_path / "out.npz").exists() if entry == "worker" else (
        tmp_path / "out" / "MO1.txt").exists()
    assert wrote != fails


def test_spmd_mesh_leaves_a_group_it_did_not_start():
    """...and a Mesh over the default group holds no reference to it (None
    stands for it), so ending the group frees it."""
    mesh = sharded.data_mesh(device="cpu")
    with sharded.spmd_mesh(device="cpu") as inner:
        x = sharded.psum(torch.ones(1), inner)
    assert x.item() == 1 and dist.is_initialized()
    assert mesh.group is None and inner.group is None


# A rank at module level: its Mesh lives on to interpreter exit, and its
# group's threads must not.
RANK = GLOO_THREADS + """
import torch

from vloam_tpu_torch.parallel.sharded import psum, spmd_mesh

torch.set_num_threads(1)
with spmd_mesh(device="cpu") as mesh:
    x = psum(torch.ones(1), mesh)
    assert x.item() == mesh.size == 2, x
assert gloo_threads() == [], gloo_threads()
"""


def test_launches_end_their_groups_cleanly(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(RANK)
    runs = [launch([str(script)], 2, timeout=LIMIT_S, env=_env())
            for _ in range(10)]
    for k, run in enumerate(runs):
        assert run.code == 0 and run.codes == [0, 0], (k, run.report())
        assert not any("terminate called" in t for t in run.tails), (
            k, run.report())


def test_cli_mesh_names_each_failing_rank(tmp_path, capfd):
    """--mesh N that fails names each rank's exit code and stderr tail."""
    from vloam_tpu_torch import cli

    rc = cli._launch_ranks(2, [
        "run", "--odometry-root", str(tmp_path / "missing"), "--seq", "00",
        "--sensor", "tiny", "--mode", "lidar-only", "--device", "cpu",
        "--verbose", "0", "--out", str(tmp_path / "out"), "--mesh", "2"])
    err = capfd.readouterr().err
    assert rc != 0 and f"--mesh 2: the ranks exited {rc}" in err, err
    assert "rank 0 exited" in err and "rank 1 exited" in err, err


def test_rank_env_shares_the_cores_it_may_run_on():
    """Pinned to 2 of the cores, the launcher gives 1, 2 and 4 ranks the
    threads of those cores, not of the host's count; and a rank that dies
    on a signal prints its Python stack (faulthandler) unless told not to."""
    pin = sorted(os.sched_getaffinity(0))[:2]
    code = ("import os\n"
            f"os.sched_setaffinity(0, {pin})\n"
            "from vloam_tpu_torch.parallel.launch import rank_env\n"
            "print([rank_env(0, n, 1, base={})['OMP_NUM_THREADS']"
            " for n in (1, 2, 4)])\n"
            "print(rank_env(0, 2, 1, base={})['PYTHONFAULTHANDLER'],"
            " rank_env(0, 2, 1, base={'PYTHONFAULTHANDLER': ''})"
            "['PYTHONFAULTHANDLER'] == '')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         check=True, capture_output=True, text=True,
                         timeout=LIMIT_S)
    want = [str(max(1, len(pin) // n)) for n in (1, 2, 4)]
    assert out.stdout.split("\n")[-3:-1] == [str(want), "1 True"]
