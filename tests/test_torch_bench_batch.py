"""The batch part of vloam_tpu_torch.tools.bench (the counterpart of
scripts/bench_extras.py::bench_batch) on the CPU at small sizes.

- The drive generator (bench.batch_drives) against the streams that
  bench_extras.bench_batch builds with the JAX package's synthetic module
  (urban_scene(b, extent=80), drive_trajectory(n, 1.1, 0.01 + 0.002 b),
  simulate_scan_polar seeded b * 1000 + k; 3 cm images clipped at 4095 for
  pack12), with the rays cut to 16 x 360: bit-identical at 5 mm and at 3
  cm, and a longer drive starts with the shorter one's frames.
- The port's BatchLoamEngine(pack12=True, quantize_mm=5.0) on the bench's 3
  cm frames against the JAX package's BatchLoamEngine with the same
  arguments at config.tiny_test_profile(): t_w_lo within 1e-3 m, t_w_mo
  within 1e-2 m (tests/test_torch_batch_engine.py's tolerances), each
  engine with its own ray directions (equal bit for bit:
  tests/test_torch_polar_geometry.py).
- The cache: a second call reads the streams back, another mode or stream
  misses it.
- bench_batch's window check, and run()'s batch keys: a failed mode goes
  into the line as batch_error, the other mode's keys stay.
"""

import math
import tempfile

import numpy as np
import pytest
import torch

from vloam_tpu import config as jcfg
from vloam_tpu.data import synthetic as jsyn
from vloam_tpu.lidar import loam_step as jls
from vloam_tpu_torch import config as tcfg
from vloam_tpu_torch.lidar import loam_step as tls
from vloam_tpu_torch.tools import bench

torch.set_num_threads(1)

S, A = 16, 360  # rays cut to 16 x 360


@pytest.fixture
def tmp_cache(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def _reference_streams(batch: int, n: int, pack: bool) -> list:
    """bench_extras.bench_batch's streams (scripts/bench_extras.py:120-134)
    with the JAX package's synthetic module, rays cut to S x A."""
    scale = 0.03 if pack else 0.005
    streams = []
    for b in range(batch):
        scene = jsyn.urban_scene(b, extent=80.0)
        poses = jsyn.drive_trajectory(n, speed=1.1,
                                      yaw_rate=0.01 + 0.002 * b)
        scans = [jsyn.simulate_scan_polar(scene, T, n_scans=S, n_azimuth=A,
                                          seed=b * 1000 + k,
                                          range_scale=scale)
                 for k, T in enumerate(poses)]
        if pack:
            scans = [np.minimum(s, 4095).astype(np.uint16) for s in scans]
        streams.append(scans)
    return streams


@pytest.mark.parametrize("pack", [False, True], ids=["uint16_5mm",
                                                     "pack12_3cm"])
def test_batch_drives_equal_bench_extras_streams(tmp_cache, pack):
    want = _reference_streams(2, 3, pack)
    got = bench.batch_drives(2, 5, S, A, pack, workers=1)
    assert len(got) == 2 and all(len(s) == 5 for s in got)
    for b in range(2):
        for k in range(3):  # the longer drive starts with the reference's
            assert got[b][k].dtype == np.uint16
            np.testing.assert_array_equal(got[b][k], want[b][k])
        assert max(int(s.max()) for s in got[b]) <= (4095 if pack else 65535)
    # the streams differ (scene, yaw rate, seeds)
    assert not np.array_equal(got[0][1], got[1][1])


def test_batch_pack12_engine_on_bench_frames_matches_jax(tmp_cache):
    batch, n, chunk = 2, 4, 2
    streams = bench.batch_drives(batch, n, S, A, True, workers=1)

    def run(eng):
        for k in range(n):
            for b in range(batch):
                eng.push_polar(b, streams[b][k],
                               range_scale=bench.PACK12_SCALE)
        return eng.finish()

    outs_j = run(jls.BatchLoamEngine(jcfg.tiny_test_profile(), batch,
                                     chunk=chunk, quantize_mm=5.0,
                                     pack12=True))
    eng = tls.BatchLoamEngine(tcfg.tiny_test_profile(), batch, chunk=chunk,
                              quantize_mm=5.0, pack12=True, device="cpu")
    outs_t = run(eng)
    assert outs_t.shape == (batch, n, 24) and np.isfinite(outs_t).all()
    for b in range(batch):
        res = tls.unpack_outputs(outs_t[b])
        ref = jls.unpack_outputs(np.asarray(outs_j[b]))
        np.testing.assert_allclose(res["t_w_lo"], ref["t_w_lo"], atol=1e-3)
        np.testing.assert_allclose(res["t_w_mo"], ref["t_w_mo"], atol=1e-2)


def test_batch_drives_are_cached(tmp_cache, monkeypatch):
    made = []
    pool_map = bench._pool_map

    def counting(fn, items, workers):
        made.extend((it[4], it[5]) for it in items)  # (stream, scale)
        return pool_map(fn, items, workers)

    monkeypatch.setattr(bench, "_pool_map", counting)
    first = bench.batch_drives(2, 2, S, A, False, workers=1)
    assert sorted(set(made)) == [(0, 0.005), (1, 0.005)] and len(made) == 4
    made.clear()
    again = bench.batch_drives(2, 2, S, A, False, workers=1)
    assert made == []  # read back
    for a, b in zip(first, again):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    bench.batch_drives(2, 2, S, A, True, workers=1)  # another scale
    assert sorted(set(made)) == [(0, 0.03), (1, 0.03)] and len(made) == 4
    made.clear()
    bench.batch_drives(3, 2, S, A, False, workers=1)  # another stream
    assert made == [(2, 0.005)] * 2
    names = [p.name for p in tmp_cache.iterdir()
             if p.name.startswith("vloam_torch_bench_batch")]
    assert len(names) == 5, names


def test_bench_batch_refuses_a_window_inside_a_chunk():
    with pytest.raises(ValueError, match="multiple of chunk"):
        bench.bench_batch(tcfg.tiny_test_profile(), [[]], "cpu", chunk=4,
                          window=6)


def test_run_reports_a_failed_batch_mode(tmp_cache, monkeypatch):
    """run()'s wiring of the batch keys, with the other parts stubbed: a
    failed pack12 run leaves batch_fps in the line and names itself in
    batch_error."""
    calls = []

    def fake_batch(cfg, streams, device, chunk, window, windows, pack):
        calls.append((len(streams), len(streams[0]), chunk, window, windows,
                      pack, streams[0][0].dtype))
        if pack:
            raise RuntimeError("pack12 broke")
        return 8.0, 6.0

    monkeypatch.setattr(bench, "bench_lidar", lambda *a: {"value": 1.0})
    monkeypatch.setattr(bench, "frame_work", lambda *a: {
        "ops": 1.0, "ops_f64": 0.0, "bytes": 1.0})
    monkeypatch.setattr(bench, "bench_combined", lambda *a: (1.0, 1.0))
    monkeypatch.setattr(bench, "bench_pose_graph", lambda *a: 1.0)
    monkeypatch.setattr(bench, "bench_batch", fake_batch)
    rec = bench.run("cpu", tcfg.tiny_test_profile(), n_azimuth=A, chunk=2,
                    warm=2, window=2, windows=3, combined=(1, 1),
                    batch=(3, 2, 4), workers=1,
                    frames=[np.zeros((S, A), np.uint16)] * 4,
                    images=[np.zeros((96, 320), np.uint8)] * 2)
    assert calls == [(3, 14, 2, 4, 3, False, np.uint16),
                     (3, 14, 2, 4, 3, True, np.uint16)]
    assert rec["batch_streams"] == 3
    assert rec["batch_fps"] == 8.0 and rec["batch_fps_median"] == 6.0
    assert "batch_pack12_fps" not in rec
    assert rec["batch_error"].startswith("batch_pack12_fps: RuntimeError")
    assert "pack12 broke" in rec["batch_error"]
    assert math.isfinite(rec["pose_graph_gn_iters_per_sec"])
