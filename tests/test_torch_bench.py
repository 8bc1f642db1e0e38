"""vloam_tpu_torch.tools.bench, the port's counterpart of bench.py, run on
the CPU at the tiny test profile with a few frames a window: the line has
bench.py's keys and the port's (the card, the host CPU, the combined
engine's frames/s, the pose graph's Gauss-Newton steps a second; of the
roofline keys the two counts and the device, with no roofline_error), its
numbers are finite and positive and no part reports a failure; cached
frames are read back, and other parameters miss the cache. Asking for the
card where there is none raises."""

import json
import math
import tempfile

import numpy as np
import pytest
import torch

from vloam_tpu_torch.config import tiny_test_profile
from vloam_tpu_torch.tools import bench

torch.set_num_threads(1)

KEYS = {"metric", "value", "unit", "vs_baseline", "value_median",
        "window_rates", "window_frames", "fence_ms", "device_ms_per_frame",
        "upload_mbps", "upload_ms_per_frame", "device", "host_cpu",
        "combined_fps", "combined_vs_baseline", "combined_fps_median",
        "pose_graph_gn_iters_per_sec", "flops_per_frame",
        "hbm_bytes_per_frame", "device_kind"}


def _run(**kw):
    return bench.run("cpu", tiny_test_profile(), n_azimuth=200, chunk=2,
                     warm=2, window=4, windows=3, combined=(2, 2),
                     n_poses=16, workers=1, **kw)


def test_bench_line_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rec = json.loads(json.dumps(_run()))
    assert set(rec) == KEYS, set(rec) ^ KEYS
    assert rec["metric"] == "loam_pipeline_frames_per_sec"
    assert rec["device"] == "cpu" and rec["host_cpu"]
    assert len(rec["window_rates"]) == 3 and rec["window_frames"] == 4
    assert rec["value"] == max(rec["window_rates"])
    assert rec["value_median"] == sorted(rec["window_rates"])[1]
    for k in ("value", "vs_baseline", "value_median", "fence_ms",
              "device_ms_per_frame", "upload_mbps", "combined_fps",
              "combined_fps_median", "pose_graph_gn_iters_per_sec"):
        assert math.isfinite(rec[k]) and rec[k] >= 0, k
    assert rec["value"] > 0 and rec["combined_fps"] > 0
    # the roofline counts: on the CPU the two counts and the device alone
    assert rec["device_kind"] == "cpu"
    for k in ("flops_per_frame", "hbm_bytes_per_frame"):
        assert math.isfinite(rec[k]) and rec[k] > 0, k
    cached = sorted(p.name for p in tmp_path.iterdir()
                    if p.name.startswith("vloam_torch_bench_"))
    assert len(cached) == 2, cached  # the range images and the images


def test_bench_frames_are_cached(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    arrs = [np.arange(6, dtype=np.uint16).reshape(2, 3)]
    assert bench._cached("x", (1, 2.0), lambda: arrs) is arrs

    def regenerate():
        raise AssertionError("generated again")

    got = bench._cached("x", (1, 2.0), regenerate)
    np.testing.assert_array_equal(got[0], arrs[0])
    assert bench._cached("x", (1, 3.0), lambda: []) == []  # other params


def test_bench_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run("cuda")
