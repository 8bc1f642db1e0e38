"""The port's command line (python -m vloam_tpu_torch) over the checked-in
KITTI-odometry-layout mini-fixture (tests/fixtures/kitti_mini), with
--device cpu, mirroring the flows of tests/test_cli_kitti.py (both engines,
--viz, --optical-flow) and holding their files to the JAX CLI's and to the
fixture's goldens.

Tolerances: the fixture goldens within 0.05 m (the reference's own bar);
the JAX CLI's LO / MO within 2e-2 / 3e-2 m and, in combined mode, VO within
3e-2 m (the golden tolerances of tests/test_golden_regression.py: the JAX
engine associates with quantized distances, the port with exact ones); a
resumed split run's relative MO pose within 0.05 m of the uninterrupted
run's (tests/test_cli_kitti.py's bar), from a checkpoint of either package.
The JAX CLI runs four times, in-process and once per module (each engine,
LiDAR-only and combined); the cross-package resumes reuse its compiled
chunks.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vloam_tpu_torch.cli import main

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# OpenMP pool stalls each small parallel CPU op when they are
# oversubscribed.
torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "kitti_mini"
BASE = ["run", "--odometry-root", str(FIXTURE), "--seq", "00", "--sensor",
        "tiny", "--chunk", "2", "--verbose", "0"]
PORT = BASE + ["--device", "cpu"]


def _load_kitti_txt(path):
    rows = np.atleast_2d(np.loadtxt(path))
    assert rows.shape[1] == 12, "KITTI format is 12 floats (3x4 row-major)"
    return rows.reshape(-1, 3, 4)


def _rel(poses, a, b):
    Ta = np.vstack([poses[a], [0, 0, 0, 1]])
    Tb = np.vstack([poses[b], [0, 0, 0, 1]])
    return (np.linalg.inv(Ta) @ Tb)[:3, :]


def _max_pos_diff(a, b):
    return float(np.linalg.norm(a[:, :, 3] - b[:, :, 3], axis=1).max())


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX CLI on the fixture, LiDAR-only and combined."""
    from vloam_tpu.cli import main as jax_main

    out = tmp_path_factory.mktemp("jax")
    for mode in ("lidar-only", "combined"):
        assert jax_main(BASE + ["--mode", mode, "--out",
                                str(out / mode)]) == 0
    return out


@pytest.fixture(scope="module")
def port_lidar(tmp_path_factory):
    """The port's LiDAR-only run with loop closure (min_gap 1, radius 50,
    as tests/test_cli_kitti.py's), its checkpoint after the last frame."""
    out = tmp_path_factory.mktemp("port_lidar")
    assert main(PORT + ["--mode", "lidar-only", "--out", str(out),
                        "--loop-close", "--loop-min-gap", "1",
                        "--loop-radius", "50"]) == 0
    return out


@pytest.mark.parametrize("mode", ["lidar-only", "combined"])
def test_cli_run_on_kitti_layout(tmp_path, mode, jax_runs, port_lidar):
    if mode == "lidar-only":
        out = port_lidar
    else:
        out = tmp_path / "combined"
        assert main(PORT + ["--mode", mode, "--out", str(out)]) == 0
    suffix = "0" if mode == "combined" else "1"
    streams = ("LO", "MO") if mode == "lidar-only" else ("VO", "LO", "MO")
    tol = {"VO": 3e-2, "LO": 2e-2, "MO": 3e-2}
    for which in streams:
        poses = _load_kitti_txt(out / f"{which}{suffix}.txt")
        assert len(poses) == 5 and np.isfinite(poses).all()
        # first pose is the cam0 start frame (identity re-basing)
        np.testing.assert_allclose(poses[0], np.eye(4)[:3], atol=1e-5)
        RtR = np.einsum("nij,nik->njk", poses[:, :, :3], poses[:, :, :3])
        np.testing.assert_allclose(
            RtR, np.broadcast_to(np.eye(3), (5, 3, 3)), atol=1e-4)
        ref = _load_kitti_txt(jax_runs / mode / f"{which}{suffix}.txt")
        d = _max_pos_diff(poses, ref)
        assert d < tol[which], (which, d)
    assert not (out / f"VO{suffix}.txt").exists() or mode == "combined"
    # LO translation roughly tracks the ground-truth arc
    gt = _load_kitti_txt(FIXTURE / "poses_00.txt")
    lo = _load_kitti_txt(out / f"LO{suffix}.txt")
    gt_dist = np.linalg.norm(gt[-1, :, 3] - gt[0, :, 3])
    lo_dist = np.linalg.norm(lo[-1, :, 3] - lo[0, :, 3])
    assert abs(lo_dist - gt_dist) < 0.5 * max(gt_dist, 1.0), (lo_dist, gt_dist)


def test_fixture_loader_shapes():
    """The mini-fixture parses through the port's KITTI loaders."""
    from vloam_tpu_torch.data.kitti import KittiOdometrySequence

    ds = KittiOdometrySequence(str(FIXTURE), "00")
    assert len(ds) == 5
    fr = ds.frame(0)
    assert fr["points"].shape[1] == 3
    assert fr["points"].shape[0] > 1000
    assert fr["image"].shape == (96, 320)
    assert ds.calib.P_velo_to_img.shape == (3, 4)


def test_cli_loop_close_flag(port_lidar):
    """--loop-close: MO1_loop.txt with 5 poses that stay consistent with
    the odometry (3 loops are accepted on the fixture by both packages,
    tests/test_torch_host_layer.py)."""
    poses = _load_kitti_txt(port_lidar / "MO1_loop.txt")
    assert len(poses) == 5 and np.isfinite(poses).all()
    mo = _load_kitti_txt(port_lidar / "MO1.txt")
    assert np.linalg.norm(poses[:, :, 3] - mo[:, :, 3], axis=1).max() < 1.0


def test_cli_save_map_and_profile(tmp_path, monkeypatch):
    """--save-map writes the accumulated map every map_pub_number frames
    (2 here: frames 2 and 4 of 5 with chunk 2), none at the default 20 on 5
    frames; --profile writes a Chrome trace."""
    from vloam_tpu_torch import config

    tiny = config.tiny_test_profile
    monkeypatch.setattr(config, "tiny_test_profile", lambda: tiny().replace(
        mapping=dataclasses.replace(tiny().mapping, map_pub_number=2)))
    maps = tmp_path / "maps"
    assert main(PORT + ["--mode", "lidar-only", "--save-map", str(maps),
                        "--profile", str(tmp_path / "trace")]) == 0
    files = sorted(p.name for p in maps.glob("*.npz"))
    assert files == ["map_000002.npz", "map_000004.npz"]
    sizes = []
    for f in files:
        with np.load(maps / f) as m:
            assert m["corner"].dtype == m["surf"].dtype == np.float32
            assert m["corner"].shape[1] == m["surf"].shape[1] == 3
            assert np.isfinite(m["surf"]).all() and len(m["surf"]) > 100
            sizes.append(len(m["surf"]))
    assert sizes[0] < sizes[1]
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    monkeypatch.setattr(config, "tiny_test_profile", tiny)
    assert main(PORT + ["--mode", "lidar-only", "--save-map",
                        str(tmp_path / "none")]) == 0
    assert not list((tmp_path / "none").glob("*.npz"))


def test_cli_golden_regression(port_lidar):
    """A fresh run reproduces the fixture's golden LO / MO trajectories."""
    for which in ("LO1", "MO1"):
        fresh = _load_kitti_txt(port_lidar / f"{which}.txt")
        golden = _load_kitti_txt(FIXTURE / "golden" / f"{which}.txt")
        d = np.linalg.norm(fresh[:, :, 3] - golden[:, :, 3], axis=1)
        assert d.max() < 0.05, (which, d)


def _jax_cfg():
    from vloam_tpu.config import tiny_test_profile

    # the JAX CLI's configuration, so its compiled chunks are reused
    return tiny_test_profile().replace(detach_VO_LO=True, verbose_level=0)


def _jax_frames(lo, hi):
    from vloam_tpu.data.kitti import KittiOdometrySequence

    ds = KittiOdometrySequence(str(FIXTURE), "00")
    return ds.calib, [{"points": ds.frame(i)["points"]}
                      for i in range(lo, hi)]


def test_cli_checkpoint_resume(tmp_path, port_lidar, jax_runs):
    """--save-state / --init-state: a run split after frame 2 continues the
    same map and pose chain. The resumed half's relative MO pose equals the
    uninterrupted run's within 0.05 m, resumed from the port's checkpoint
    (by the port's CLI and by the JAX pipeline) and from the JAX
    package's (by the port's CLI)."""
    from vloam_tpu.pipeline import run_sequence_fused as jax_run

    ck = tmp_path / "port.npz"
    assert main(PORT + ["--mode", "lidar-only", "--end-frame", "2", "--out",
                        str(tmp_path / "part1"), "--save-state",
                        str(ck)]) == 0
    assert len(_load_kitti_txt(tmp_path / "part1" / "MO1.txt")) == 3
    full = _rel(_load_kitti_txt(port_lidar / "MO1.txt"), 3, 4)
    full_j = _rel(_load_kitti_txt(jax_runs / "lidar-only" / "MO1.txt"), 3, 4)

    def resumed(state, name):
        out = tmp_path / name
        assert main(PORT + ["--mode", "lidar-only", "--start-frame", "3",
                            "--out", str(out), "--init-state",
                            str(state)]) == 0
        part2 = _load_kitti_txt(out / "MO1.txt")
        assert len(part2) == 2
        return _rel(part2, 0, 1)

    np.testing.assert_allclose(resumed(ck, "part2")[:, 3], full[:, 3],
                               atol=0.05)
    # the JAX package's checkpoint after frames 0-2, resumed by the port
    calib, frames = _jax_frames(0, 3)
    jck = tmp_path / "jax.npz"
    jax_run(_jax_cfg(), calib, frames, chunk=2, lidar_only=True,
            save_state_path=str(jck))
    np.testing.assert_allclose(resumed(jck, "from_jax")[:, 3], full[:, 3],
                               atol=0.05)
    # the port's checkpoint, resumed by the JAX package
    calib, frames = _jax_frames(3, 5)
    res = jax_run(_jax_cfg(), calib, frames, chunk=2, lidar_only=True,
                  init_state=str(ck))
    np.testing.assert_allclose(_rel(res["MO"], 0, 1)[:, 3], full_j[:, 3],
                               atol=0.05)


def test_cli_compare_ref_harness(capsys, port_lidar):
    """--compare-ref against the run's own earlier results directory
    reports ~zero ATE for every stream."""
    capsys.readouterr()
    assert main(PORT + ["--mode", "lidar-only", "--compare-ref",
                        str(port_lidar)]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("compare-ref ")]
    streams = {}
    for ln in lines:
        name, payload = ln[len("compare-ref "):].split(": ", 1)
        streams[name] = json.loads(payload)
    assert "LO1" in streams and "MO1" in streams, lines
    for name, m in streams.items():
        assert m["n_frames"] == 5
        assert m["ate_rmse_m"] < 1e-3, (name, m)


def test_cli_polar_ingest_and_synthetic(tmp_path, capsys, port_lidar):
    """--polar-ingest (native projection, uint16 range images) on the
    fixture, and a --synthetic drive with its metrics printed."""
    out = tmp_path / "polar"
    assert main(PORT + ["--mode", "lidar-only", "--polar-ingest", "--out",
                        str(out), "--verbose", "1"]) == 0
    printed = capsys.readouterr().out
    assert "kitti io: native" in printed and "polar ingest" in printed
    mo = _load_kitti_txt(out / "MO1.txt")
    assert len(mo) == 5 and np.isfinite(mo).all()
    assert main(["run", "--synthetic", "3", "--sensor", "tiny", "--mode",
                 "lidar-only", "--device", "cpu", "--verbose", "0"]) == 0
    printed = capsys.readouterr().out
    lines = {ln[:2]: json.loads(ln[3:]) for ln in printed.splitlines()
             if ln[:3] in ("LO ", "MO ")}
    assert lines.keys() == {"LO", "MO"}
    # 16 rings of the tiny profile in the synthetic street: a short, weakly
    # constrained drive (the JAX CLI's LO ATE max there is 2.96 m too)
    assert lines["LO"]["ate_max_m"] < 5.0
    assert np.isfinite(lines["MO"]["ate_rmse_m"])


def test_cli_eval(tmp_path, capsys):
    assert main(["eval", "--gt", str(FIXTURE / "poses_00.txt"), "--pred",
                 str(FIXTURE / "golden" / "MO1.txt")]) == 0
    m = json.loads(capsys.readouterr().out)
    assert 0 <= m["ate_rmse_m"] < 0.5 and m["ate_max_m"] >= m["ate_rmse_m"]


@pytest.fixture(scope="module")
def jax_host_runs(tmp_path_factory):
    """The JAX CLI's host engine on the fixture, LiDAR-only and combined
    (the latter with --viz)."""
    from vloam_tpu.cli import main as jax_main

    out = tmp_path_factory.mktemp("jax_host")
    for mode, extra in (("lidar-only", []),
                        ("combined", ["--viz", str(out / "viz")])):
        assert jax_main(BASE + ["--mode", mode, "--engine", "host", "--out",
                                str(out / mode)] + extra) == 0
    return out


@pytest.mark.parametrize("mode", ["lidar-only", "combined"])
def test_cli_host_engine(tmp_path, capsys, mode, jax_host_runs):
    """--engine host on the fixture: the three streams (VO stays at the
    start frame in LiDAR-only mode, as the reference's), per-frame progress
    and the timing summary; each stream within the golden tolerances of the
    JAX CLI's host engine, and of the fixture's golden trajectories."""
    out = tmp_path / mode
    extra = ["--viz", str(tmp_path / "viz")] if mode == "combined" else []
    assert main(PORT + ["--mode", mode, "--engine", "host", "--out", str(out),
                        "--verbose", "1"] + extra) == 0
    printed = capsys.readouterr().out
    assert sum(ln.startswith("frame ") for ln in printed.splitlines()) == 5
    summary = json.loads(printed.split("timing summary (ms):", 1)[1].split(
        "\n}", 1)[0] + "}")
    stages = {"t_scanreg_ms", "t_lo_ms", "t_mo_ms", "t_frame_ms"}
    if mode == "combined":
        stages |= {"t_image_ms", "t_depth_ms", "t_vo_solve_ms"}
    assert set(summary) == stages and summary["t_frame_ms"] > 0
    suffix = "0" if mode == "combined" else "1"
    tol = {"VO": 3e-2, "LO": 2e-2, "MO": 3e-2}
    for which in ("VO", "LO", "MO"):
        poses = _load_kitti_txt(out / f"{which}{suffix}.txt")
        assert len(poses) == 5 and np.isfinite(poses).all()
        np.testing.assert_allclose(poses[0], np.eye(4)[:3], atol=1e-5)
        ref = _load_kitti_txt(jax_host_runs / mode / f"{which}{suffix}.txt")
        assert _max_pos_diff(poses, ref) < tol[which], which
    if mode == "lidar-only":
        for which in ("LO1", "MO1"):
            golden = _load_kitti_txt(FIXTURE / "golden" / f"{which}.txt")
            fresh = _load_kitti_txt(out / f"{which}.txt")
            assert _max_pos_diff(fresh, golden) < 0.05, which
    else:
        # --viz: the JAX CLI's debug PNGs, by name
        names = sorted(p.name for p in (tmp_path / "viz").glob("*.png"))
        assert names == sorted(p.name for p in (jax_host_runs / "viz").glob(
            "*.png")) == ["depth_000001.png", "matches_000001.png"]


def test_cli_viz_flow_mode(tmp_path):
    """--viz --optical-flow on the host engine: flow-arrow and depth PNGs,
    no match PNG (tests/test_cli_kitti.py's test_cli_viz_flow_mode)."""
    viz = tmp_path / "viz"
    assert main(PORT + ["--mode", "combined", "--engine", "host", "--out",
                        str(tmp_path / "out"), "--viz", str(viz),
                        "--optical-flow"]) == 0
    names = sorted(p.name for p in viz.glob("*.png"))
    assert names == ["depth_000001.png", "flow_000001.png"]
    from PIL import Image

    with Image.open(viz / "flow_000001.png") as im:
        assert im.size == (320, 96) and im.mode == "RGB"
    vo = _load_kitti_txt(tmp_path / "out" / "VO0.txt")
    assert len(vo) == 5 and np.isfinite(vo).all()


@pytest.mark.parametrize("flags,item", [
    (["--device", "cuda", "--mesh", "2"], "needs 2 visible cards"),
    (["--reference-exact"], "HDL-64"),
    (["--polar-ingest", "--engine", "host"], "only the fused engine")])
def test_cli_refuses_what_is_not_ported(capsys, flags, item):
    """What the command line cannot run ends with an argparse error naming
    the reason, no silent substitute: --mesh 2 under --device cuda (the
    default) without 2 visible cards, the HDL-64 parity profile with another
    sensor, and the host engine's polar ingest (the reference's host engine
    cannot read it either). The mesh itself runs:
    tests/test_torch_mesh_multiprocess.py."""
    if "--mesh" in flags and torch.cuda.device_count() >= 2:
        pytest.skip("two cards are visible: the mesh runs there")
    with pytest.raises(SystemExit) as e:
        main(PORT + ["--mode", "lidar-only"] + flags)
    assert e.value.code == 2
    assert item in capsys.readouterr().err


def test_cli_combined_checkpoint_resume(tmp_path):
    """The combined engine's (VisionLoState, MapState) pair through
    --save-state / --init-state: the resumed half's relative MO pose equals
    the uninterrupted run's within 0.05 m."""
    runs = {}
    for name, extra in (("full", []),
                        ("part1", ["--end-frame", "2", "--save-state",
                                   str(tmp_path / "pair.npz")]),
                        ("part2", ["--start-frame", "3", "--init-state",
                                   str(tmp_path / "pair.npz")])):
        out = tmp_path / name
        assert main(PORT + ["--mode", "combined", "--out", str(out)]
                    + extra) == 0
        runs[name] = _load_kitti_txt(out / "MO0.txt")
    assert [len(r) for r in runs.values()] == [5, 3, 2]
    np.testing.assert_allclose(_rel(runs["part2"], 0, 1)[:, 3],
                               _rel(runs["full"], 3, 4)[:, 3], atol=0.05)
    with np.load(tmp_path / "pair.npz") as ck:
        assert "0/vision/prev_desc" in ck.files and "1/cube/surf/pts" in \
            ck.files


def test_cli_reference_exact_profile(capsys):
    """--reference-exact runs the HDL-64 parity profile (a 2-frame
    synthetic drive at full width)."""
    assert main(["run", "--synthetic", "2", "--reference-exact", "--mode",
                 "lidar-only", "--device", "cpu", "--verbose", "0"]) == 0
    printed = capsys.readouterr().out
    lo = [json.loads(ln[3:]) for ln in printed.splitlines()
          if ln.startswith("LO ")]
    assert lo and lo[0]["ate_max_m"] < 0.1
