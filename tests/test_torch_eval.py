"""The port's accuracy evaluations (vloam_tpu_torch/tools/eval_*.py)
against the JAX package's scripts, on the CPU at small sizes.

- The drives of tools/eval_frames.py against each script's generator
  (scripts/eval_synthetic.py, eval_long.py, eval_highway.py loaded by path
  with their CACHE in the test's directory; eval_loop_closure.py's lines
  38-57, which have no function, repeated here with the JAX package's
  synthetic module). At full size with the scene, scan and render calls
  recorded instead of run: every call's arguments (scene, pose, rays,
  noise, seed, camera) and the ground truth identical. Then 2 frames made
  for real with the rays cut to 16 x 360 in both (the JAX package's
  functions wrapped to take those sizes) and the tiny profile's 320 x 96
  camera: points, range images, images and ground truth bit-identical.
- Each tool's run function on an 8-12 frame drive at config.tiny_test_profile()
  and 16 rings against the JAX package's same calls (run_sequence_fused,
  LoamEngine with unpack_outputs, close_loops): LO within 2e-2 m and MO
  within 3e-2 m (tests/test_golden_regression.py's tolerances), VO within
  3e-2 m, the same loops and VO match counts. The highway's run function runs
  all four configurations; the guarded one is held to the JAX engine (which
  compiles anew for each configuration) and the detached one to the
  guarded one (the gate fires on every frame, so their LO and MO agree).
  The gate-off configuration feeds the LO garbage VO seeds by design,
  which amplify the rounding between the packages without bound: it and
  the low-texture fallback are checked finite.
- Each tool refuses the card where there is none, runs with --device cpu,
  and writes its JSON lines to --out and nothing else: RESULTS.md and
  tests/golden/ keep their bytes.
"""

import dataclasses
import hashlib
import importlib.util
import inspect
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from vloam_tpu import config as jcfg
from vloam_tpu.data import synthetic as jsyn
from vloam_tpu_torch import config as tcfg
from vloam_tpu_torch.data import synthetic as tsyn
from vloam_tpu_torch.tools import (eval_frames, eval_highway, eval_long,
                                   eval_loop_closure, eval_synthetic)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(n_scans=16, n_azimuth=360)
TOL = {"LO": 2e-2, "MO": 3e-2, "VO": 3e-2}
DRAWN = ("simulate_scan", "simulate_scan_polar", "render_camera")


@pytest.fixture
def tmp_cache(monkeypatch, tmp_path):
    """The drives' cache (the temporary directory) under tmp_path."""
    d = tmp_path / "cache"
    d.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(d))
    return d


def _script(name, tmp_path, monkeypatch):
    """scripts/<name>.py as a module, its frame cache under tmp_path."""
    monkeypatch.setattr(sys, "path", list(sys.path))  # it prepends the repo
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.CACHE = tmp_path / f"{name}_cache"
    return mod


def _ref_loop_drive(n_frames):
    """scripts/eval_loop_closure.py:38-57 (its scans and ground truth)."""
    yaw = 2.0 * np.pi / n_frames
    poses = jsyn.drive_trajectory(n_frames, speed=1.0, yaw_rate=yaw)
    scene = jsyn.urban_scene(5, extent=90.0, n_boxes=20, n_poles=40,
                             scatter=40)
    scans = [jsyn.simulate_scan(scene, T, n_scans=64, n_azimuth=1800,
                                noise=0.01, seed=k)
             for k, T in enumerate(poses)]
    return scans, np.stack([T[:3, :] for T in poses])


def _reference(drive, n, tmp_path, monkeypatch, cfg):
    """The script's drive: (frames as dicts of arrays, gt, calib)."""
    if drive == "loop":
        scans, gt = _ref_loop_drive(n)
        return [{"points": s} for s in scans], gt, None
    if drive == "long":
        frames, gt = _script("eval_long", tmp_path, monkeypatch).build_frames(
            n)
        return [{"polar": f} for f in frames], gt, None
    if drive == "highway":
        calib, frames, gt = _script("eval_highway", tmp_path,
                                    monkeypatch).build_frames(n, cfg)
        return frames, gt, calib
    mod = _script("eval_synthetic", tmp_path, monkeypatch)
    calib, frames, gt = mod.build_frames(n, with_cam=True, cfg=cfg)
    _, polar, _ = mod.build_frames(n, with_cam=True, cfg=cfg, with_polar=True)
    return [dict(f, polar=p["polar"]) for f, p in zip(frames, polar)], gt, \
        calib


def _port(drive, n, cfg, n_scans=64, n_azimuth=1800):
    """The port's function for the same drive, in the same form."""
    kw = dict(n_scans=n_scans, n_azimuth=n_azimuth, workers=1)
    if drive == "loop":
        scans, gt = eval_frames.loop_drive(n, **kw)
        return [{"points": s} for s in scans], gt, None
    if drive == "long":
        frames, gt = eval_frames.long_drive(n, **kw)
        return [{"polar": f} for f in frames], gt, None
    if drive == "highway":
        calib, frames, gt = eval_frames.highway_drive(n, cfg, **kw)
        return frames, gt, calib
    calib, frames, gt = eval_frames.synthetic_drive(n, cfg, True, False, **kw)
    _, polar, gt_p = eval_frames.synthetic_drive(n, cfg, True, True, **kw)
    np.testing.assert_array_equal(gt_p, gt)
    return [dict(f, polar=p["polar"]) for f, p in zip(frames, polar)], gt, \
        calib


def _canon(value):
    """A call argument as comparable bytes (scenes field by field)."""
    if dataclasses.is_dataclass(value):
        return tuple(_canon(getattr(value, f.name))
                     for f in dataclasses.fields(value))
    if isinstance(value, np.ndarray):
        return (value.dtype.str, value.shape, value.tobytes())
    return value


def _recorder(monkeypatch, module, calls):
    """Replace the module's scan / render functions by stubs that record
    their bound arguments and return a 1 x 1 array."""
    for name in DRAWN:
        sig = inspect.signature(getattr(tsyn, name))

        def stub(*args, _name=name, _sig=sig, **kw):
            bound = _sig.bind(*args, **kw)
            bound.apply_defaults()
            calls.setdefault(_name, []).append(
                {k: _canon(v) for k, v in bound.arguments.items()})
            return np.zeros((1, 1), np.float32)

        monkeypatch.setattr(module, name, stub)


FULL = {"synthetic": 100, "long": 500, "loop": 320, "highway": 80}


@pytest.mark.parametrize("drive", list(FULL))
def test_drive_equals_its_script(drive, tmp_path, tmp_cache, monkeypatch):
    n = FULL[drive]
    with monkeypatch.context() as m:
        want_calls, got_calls = {}, {}
        _recorder(m, jsyn, want_calls)
        _recorder(m, tsyn, got_calls)
        _, gt_want, calib_want = _reference(drive, n, tmp_path, m,
                                            jcfg.kitti_hdl64())
        _, gt_got, calib_got = _port(drive, n, tcfg.kitti_hdl64())
    assert set(got_calls) == set(want_calls)
    for name, calls in want_calls.items():
        assert len(calls) == n, name
        assert got_calls[name] == calls, name
    np.testing.assert_array_equal(gt_got, gt_want)
    if calib_want is not None:
        for field in ("K", "P_velo_to_img", "imu_T_velo", "imu_T_cam0"):
            np.testing.assert_array_equal(getattr(calib_got, field),
                                          getattr(calib_want, field))

    # two frames made for real, the rays cut to 16 x 360 in both
    for name in DRAWN[:2]:
        real = getattr(jsyn, name)
        monkeypatch.setattr(jsyn, name, lambda *a, _real=real, **kw: _real(
            *a, **{**kw, **SMALL}))
    (tmp_path / "small").mkdir()
    want, gt_want, _ = _reference(drive, 2, tmp_path / "small", monkeypatch,
                                  jcfg.tiny_test_profile())
    got, gt_got, _ = _port(drive, 2, tcfg.tiny_test_profile(), **SMALL)
    np.testing.assert_array_equal(gt_got, gt_want)
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key])
    if "image" in want[0]:
        assert want[0]["image"].shape == (96, 320)


# ------------------------------------------------------ the run functions

def _close(got, want, streams, what=""):
    for s in streams:
        d = float(np.abs(got[s][:, :3, 3] - want[s][:, :3, 3]).max())
        assert d < TOL[s], (what, s, d)


def test_synthetic_run_matches_jax(tmp_cache):
    from vloam_tpu.pipeline import run_sequence_fused

    cfg = tcfg.tiny_test_profile()
    calib, frames, gt = eval_frames.synthetic_drive(10, cfg, workers=1,
                                                    **SMALL)
    rec, res = eval_synthetic.run_mode("lidar_only", calib, frames, gt, cfg,
                                       "cpu", runs=1)
    want = run_sequence_fused(jcfg.tiny_test_profile(), calib, iter(frames),
                              lidar_only=True, chunk=10)
    _close(res, want, ("LO", "MO"))
    assert set(rec["metrics"]) == {"LO", "MO"} and rec["device"] == "cpu"
    assert rec["metrics"]["MO"]["ate_max_m"] < 0.15
    assert rec["fps_first"] == rec["fps_steady"] > 0


def test_long_run_matches_jax(tmp_cache):
    """10 frames at chunk 4: the port's last chunk holds 2 frames and
    finish() runs it; the JAX engine at chunk 5 (no tail to compile)."""
    from vloam_tpu.lidar.loam_step import LoamEngine, unpack_outputs

    cfg = tcfg.tiny_test_profile()
    frames, gt = eval_frames.long_drive(10, workers=1, **SMALL)
    rec, raw = eval_long.run(frames, gt, cfg, "cpu", chunk=4, warm=4)
    eng = LoamEngine(jcfg.tiny_test_profile(), chunk=5)
    for f in frames:
        eng.push_polar(f)
    want = unpack_outputs(eng.finish())
    assert raw["t_w_mo"].shape == (10, 3)
    for s in ("LO", "MO"):
        d = float(np.abs(raw[f"t_w_{s.lower()}"]
                         - want[f"t_w_{s.lower()}"]).max())
        assert d < TOL[s], (s, d)
    assert rec["degraded_frames"] == len(want["lo_degraded"])
    m = cfg.mapping
    for name, cap in (("corner", m.corner_bucket_cap),
                      ("surf", m.surf_bucket_cap)):
        occ = rec["map"][name]
        assert (occ["buckets"], occ["cap"]) == (m.map_n_buckets, cap)
        assert 0 < occ["full_buckets"] * cap <= occ["live_slots"]
    assert rec["crossings"] == int(rec["distance_m"] // m.cube_size)


def test_loop_closure_run_matches_jax(tmp_cache):
    """The first 10 frames of a 48-frame circle, loops searched 4 frames
    apart; the JAX engine at chunk 10, as the synthetic run's test
    compiles it."""
    from vloam_tpu.backend.loop_closure import close_loops
    from vloam_tpu.lidar.loam_step import LoamEngine, unpack_outputs

    cfg, cfg_j = tcfg.tiny_test_profile(), jcfg.tiny_test_profile()
    scans, gt = eval_frames.loop_drive(48, workers=1, **SMALL)
    scans, gt = scans[:10], gt[:10]
    args = dict(eval_loop_closure.LOOP_ARGS, min_gap=4)
    out = eval_loop_closure.run(scans, gt, cfg, "cpu", chunk=4,
                                loop_args=args)
    eng = LoamEngine(cfg_j, chunk=10)
    for s in scans:
        eng.push(s)
    raw = unpack_outputs(eng.finish())
    for (rec, res), s in zip(out, ("LO", "MO"), strict=True):
        want = close_loops(raw[f"q_w_{s.lower()}"], raw[f"t_w_{s.lower()}"],
                           lambda k: jsyn.pad_scan(scans[k],
                                                   cfg_j.lidar.max_points),
                           cfg_j, **args)
        assert rec["chain"] == s and len(rec["loops"]) > 0
        assert rec["loops"] == [list(p) for p in want["loops"]]
        d = float(np.abs(res["poses"][:, 4:]
                         - np.asarray(want["poses"])[:, 4:]).max())
        assert d < TOL[s], (s, d)
        assert rec["metrics_closed"]["ate_rmse_m"] < 0.15


def test_highway_run_matches_jax(tmp_cache):
    from vloam_tpu.pipeline import run_sequence_fused

    cfg, cfg_j = tcfg.tiny_test_profile(), jcfg.tiny_test_profile()
    calib, frames, gt = eval_frames.highway_drive(8, cfg, workers=1, **SMALL)
    out = eval_highway.run(calib, frames, gt, cfg, "cpu")
    names = [name for name, _, _ in eval_highway.configs(cfg)]
    assert [rec["config"] for rec, _ in out] == names
    (det, res_det), (rec, res) = out[:2]
    name, cfg_c, streams = eval_highway.configs(cfg_j)[1]
    want = run_sequence_fused(cfg_c, calib, iter(frames), chunk=10)
    _close(res, want, streams, name)
    n_match = want["raw"]["n32"] + want["raw"]["n22"]
    assert rec["mean_matches"] == float(np.mean(n_match[1:]))
    assert set(rec["metrics"]) == set(streams)
    assert set(det["metrics"]) == {"LO", "MO"}
    # the gate fired on every frame, so no VO reached LO: the detached
    # engine's LO and MO are the guarded one's
    assert rec["vo_gate_fired"] == len(frames) - 1
    for s in ("LO", "MO"):
        np.testing.assert_allclose(res_det[s], res[s], rtol=0, atol=1e-6)
    # the gate-off and low-texture rows: finite, scored on their streams
    for rec, res in out[2:]:
        assert set(rec["metrics"]) == {"VO", "LO", "MO"}
        assert all(np.isfinite(res[s]).all() for s in ("VO", "LO", "MO"))


# ------------------------------------------------------------ the tools

def _digests():
    paths = [REPO / "RESULTS.md", *sorted((REPO / "tests" / "golden").glob(
        "*"))]
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in paths}


TOOLS = {
    "eval_synthetic": (eval_synthetic, ["--modes", "lidar_only"], 1),
    "eval_long": (eval_long, [], 1),
    "eval_loop_closure": (eval_loop_closure, [], 2),
    "eval_highway": (eval_highway, [], 4),
}


@pytest.mark.parametrize("tool", list(TOOLS))
def test_tool_runs_on_the_cpu_and_writes_only_its_out(tool, tmp_path,
                                                      tmp_cache, monkeypatch):
    mod, extra, n_lines = TOOLS[tool]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            mod.main(["--frames", "3"])
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    before = _digests()
    out = tmp_path / "out.jsonl"
    assert mod.main(["--frames", "3", "--device", "cpu", "--out", str(out),
                     *extra], cfg=tcfg.tiny_test_profile(), workers=1,
                    **SMALL) == 0
    assert _digests() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "cache", "cwd", "out.jsonl"]
    assert list(cwd.iterdir()) == []
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == n_lines
    assert all(r["frames"] == 3 and r["device"] == "cpu" for r in recs)
    assert all(r["host_cpu"] for r in recs)
