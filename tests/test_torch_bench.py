"""vloam_tpu_torch.tools.bench, the port's counterpart of bench.py, run on
the CPU at the tiny test profile with a few frames a window: the line has
bench.py's keys and the port's (the card, the host CPU, the combined
engine's frames/s, the batch engine's aggregate frames/s at uint16 and
pack12 over 2 streams, the pose graph's Gauss-Newton steps a second; of the
roofline keys the two counts and the device, with no roofline_error), its
numbers are finite and positive and no part reports a failure; cached
frames are read back, and other parameters miss the cache. Asking for the
card where there is none raises. tests/test_torch_bench_batch.py holds the
batch drives to scripts/bench_extras.py's."""

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
        "hbm_bytes_per_frame", "device_kind", "batch_streams", "batch_fps",
        "batch_fps_median", "batch_pack12_fps", "batch_pack12_fps_median"}


def test_bench_line_on_the_cpu(monkeypatch, tmp_path, capsys):
    """The command line with --device cpu, its run() at the tiny sizes."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    run = bench.run
    monkeypatch.setattr(bench, "run", lambda device: run(
        device, tiny_test_profile(), n_azimuth=200, chunk=2, warm=2,
        window=4, windows=3, combined=(2, 2), batch=(2, 2, 2), n_poses=16,
        workers=1))
    assert bench.main(["--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out)
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
    assert rec["batch_streams"] == 2
    for k in ("batch_fps", "batch_fps_median", "batch_pack12_fps",
              "batch_pack12_fps_median"):
        assert math.isfinite(rec[k]) and rec[k] > 0, k
    assert rec["batch_fps"] >= rec["batch_fps_median"]
    # the roofline counts: on the CPU the two counts and the device alone
    assert rec["device_kind"] == "cpu"
    for k in ("flops_per_frame", "hbm_bytes_per_frame"):
        assert math.isfinite(rec[k]) and rec[k] > 0, k
    cached = sorted(p.name for p in tmp_path.iterdir()
                    if p.name.startswith("vloam_torch_bench_"))
    # the range images, the images and each batch stream at 5 mm and at 3 cm
    assert len(cached) == 2 + 2 * 2, cached


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
