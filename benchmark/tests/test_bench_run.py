"""CPU rehearsals of the benchmark's run: the window's whole-chunk rule and
its device time a frame, the trace arithmetic and the per-layer readers on fake
records, the result's line, and the reference's verdict at the small test
profile: the port's runs correct, the control and each planted fault not.
The run on the card is marked `cuda` and skips here."""

from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness, readings, run, trace
from benchmark.tests import tiny

LO = "vloam_tpu_torch.lidar.loam_step"


def test_window_pushes_whole_chunks():
    """The window ends on the first full chunk at or past `seconds`."""
    now, pushed = [0.0], []

    def push(k):  # each push takes 0.7 s of the fake clock
        pushed.append(k)
        now[0] += 0.7

    k = harness.run_window(push, 8, 4, 5.0, lambda: now[0])
    assert pushed == list(range(8, k))
    assert len(pushed) == 8  # 5 s pass at the 8th push, a chunk's end


def test_device_ms_per_frame_is_the_window_over_its_frames(monkeypatch):
    """The untraced run's end-to-end metrics in BENCHMARK.json's order: the
    union of the window's device intervals over every frame pushed in it,
    and the set-up time."""
    spans = [(0, 3_000_000), (1_000_000, 5_000_000), (9_000_000, 10_000_000)]
    monkeypatch.setattr(trace, "device_intervals", lambda prof: spans)
    cell = tiny.cell(chunk=2)
    res = run.measure(cell, 2**31 + 17, 0.5, False, "cpu")
    m = res["metrics"]
    assert list(m) == ["device_ms_per_frame", "setup_s"]
    assert res["attempted"] % cell.chunk == 0 and res["attempted"] > 0
    assert m["device_ms_per_frame"]["unit"] == "ms"
    assert m["device_ms_per_frame"]["value"] == pytest.approx(
        6.0 / res["attempted"])
    assert m["setup_s"]["value"] > 0
    assert res["correct"] and res["failed"] == 0


def test_device_time_left_out_without_device_records():
    """A window with no device record (the CPU) reports no device time,
    never 0."""
    res = run.measure(tiny.cell(chunk=2), 7, 0.2, False, "cpu")
    assert list(res["metrics"]) == ["setup_s"]


def _fake_records():
    R = trace.Record
    return [R("kernA", True, 100, 50), R("kernB", True, 120, 60),  # 100-180
            R("Memcpy HtoD", True, 400, 100),  # 400-500
            R("kernA", True, 900, 100),  # 900-1000
            R("aten::mul", False, 150, 500), R("aten::add", False, 600, 350),
            R("cudaLaunchKernel", False, 160, 5),
            R("cudaLaunchKernel", False, 610, 5),
            R("cudaMemcpyAsync", False, 390, 5),
            R("cudaStreamSynchronize", False, 990, 20)]


def test_trace_arithmetic():
    recs = _fake_records()
    assert trace.busy_ns(recs) == 80 + 100 + 100
    assert trace.launch_calls(recs) == 3
    assert trace.top_device_ops(recs, 2) == [["kernA", 150e-9],
                                             ["Memcpy HtoD", 100e-9]]
    # gaps 180-400 (middle 290: aten::mul) and 500-900 (700: aten::add)
    assert trace.idle_gaps(recs) == [["aten::add", 400e-9],
                                     ["aten::mul", 220e-9]]


def test_readers_on_fake_records():
    recs = _fake_records()
    ctx = SimpleNamespace(recs=recs, frames_traced=2, window_s=1e-6,
                          busy_s=trace.busy_ns(recs) / 1e9, enqueue_s=0.3,
                          enqueue_frames=3, host_window_s=0.25,
                          work={"ops": 67e3, "ops_f64": 0, "bytes": 0})
    read = {m: harness.load_reader(m)(ctx) for m in (
        "host_frames_per_s", "enqueue_ms_per_frame",
        "cuda_launch_calls_per_frame", "device_idle_pct",
        "device_roofline_pct")}
    assert read["host_frames_per_s"] == pytest.approx(12.0)
    assert read["enqueue_ms_per_frame"] == pytest.approx(100.0)
    assert read["cuda_launch_calls_per_frame"] == 1.5
    assert read["device_idle_pct"] == pytest.approx(72.0)
    # 67e3 float32 operations take 1 ns at 67 TFLOP/s, of 140 ns a frame
    assert read["device_roofline_pct"] == pytest.approx(100 / 140)
    ctx.work, ctx.busy_s = None, 0.0
    assert harness.load_reader("device_roofline_pct")(ctx) is None
    assert harness.load_reader("device_idle_pct")(ctx) is None


def test_traced_result_line(tmp_path, monkeypatch):
    """A traced run's result from fake profiler records: the keys in the
    contract's order, every per-layer metric with BENCHMARK.json's unit,
    device busy and window, the breakdown from the records, and the
    numbers compared last, each with its limit."""
    monkeypatch.setattr(trace, "records", lambda prof: _fake_records())
    cell = tiny.cell(chunk=2)
    res = run.measure(cell, 5, 0.3, True, "cpu", out_dir=tmp_path)
    res.pop("log")
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    units = {m["name"]: m["unit"] for m in cell.per_layer}
    assert set(res["metrics"]) == set(units)
    assert all(v["unit"] == units[k] for k, v in res["metrics"].items())
    assert res["metrics"]["cuda_launch_calls_per_frame"]["value"] == 1.5
    assert res["metrics"]["host_frames_per_s"]["value"] > 0
    assert res["device"]["busy_s"] == 280e-9
    assert res["breakdown"]["idle_gaps"][0] == ["aten::add", 400e-9]
    assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(res["device"])
    assert set(res["checks"]) == set(cell.params["limits"])
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.loads(json.dumps(res))
    assert list(tmp_path.glob("*.trace.jsonl.gz"))


@pytest.mark.parametrize("kind", ["stream", "camera", "lockstep"])
def test_port_correct_and_control_not(kind):
    """The port's rows agree with the reference (gaps 0 on the CPU, where
    both run the same plain versions); the control, the reference with its
    clouds and images in bfloat16, reads past the cell's limits."""
    cell = {"stream": tiny.cell(), "camera": tiny.cell(camera=True),
            "lockstep": tiny.cell(streams=2)}[kind]
    r = readings.seed_readings(cell, 21, 0.3, "cpu", control=True)
    limits = cell.params["limits"]
    assert all(v <= limits[k] for k, v in r["program"].items())
    assert any(v > limits[k] for k, v in r["control"].items())


def _alter(monkeypatch, name, fn):
    import importlib

    mod = importlib.import_module(LO)
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **kw: fn(real, *a, **kw))


def test_fault_state_unchanged(monkeypatch):
    """A frame step that returns its state unchanged."""
    _alter(monkeypatch, "loam_frame_step_feats",
           lambda real, state, *a: (state, real(state, *a)[1]))
    assert not run.measure(tiny.cell(), 3, 0.3, False, "cpu")["correct"]


def test_fault_answer_altered(monkeypatch):
    """A pose altered where it is produced, by ten times the LO limit."""
    cell = tiny.cell()
    shift = 10 * cell.params["limits"]["lo_pose_gap_m"]

    def step(real, *a):
        state, out = real(*a)
        return state, out + torch.nn.functional.pad(
            torch.tensor([shift]), (4, out.shape[0] - 5))

    _alter(monkeypatch, "loam_frame_step_feats", step)
    assert not run.measure(cell, 3, 0.3, False, "cpu")["correct"]


@pytest.mark.parametrize("streams", [2, 4])
def test_fault_half_the_streams_left_out(monkeypatch, streams):
    """The lockstep engine runs half its streams and hands their rows to
    the other half: caught where every stream is followed (2) and where
    the streams past the followed ones have their LO checked alone (4)."""
    def chunk(real, *a, **kw):
        states, outs = real(*a, **kw)
        h = outs.shape[0] // 2
        return states, torch.cat([outs[:h], outs[:outs.shape[0] - h]])

    _alter(monkeypatch, "loam_run_chunk_batch_polar", chunk)
    cell = tiny.cell(streams=streams)
    assert cell.params["checked_streams"] == 2
    assert not run.measure(cell, 3, 0.3, False, "cpu")["correct"]


def test_fault_half_the_streams_mo_left_out(monkeypatch):
    """Batch MO returns its prediction for the second half of the streams,
    their LO untouched, on a seed whose followed streams are all in the
    first half: the early checks of the streams not followed catch it."""
    def solve(real, gm, *a):
        gm, q_w, t_w = real(gm, *a)
        q_pred, t_pred = a[4], a[5]
        h = q_w.shape[0] // 2
        return (gm, torch.cat([q_w[:h], q_pred[h:].to(q_w.dtype)]),
                torch.cat([t_w[:h], t_pred[h:].to(t_w.dtype)]))

    _alter(monkeypatch, "batch_solve_mapping", solve)
    cell = tiny.cell(streams=4)
    seed = next(s for s in range(1000)
                if harness.checked_streams(s, 4, 2) == [0, 1])
    res = run.measure(cell, seed, 0.3, False, "cpu")
    assert not res["correct"]
    assert res["checks"]["mo_pose_gap_m"]["value"] > \
        res["checks"]["mo_pose_gap_m"]["limit"]


def test_checked_frames_hold_chunk_starts():
    """Every followed stream is checked at the window's first frame and at
    a later chunk's first; a stream not followed at the window's first
    frame, inside its first chunk and at the next chunk's first."""
    for seed in (3, 2**31 + 5, 4000000007):
        ks = harness.checked_frames(seed, 200, 6, 16)
        assert {0, 1, 16, 199} <= set(ks)
        assert any(k % 16 == 0 and k >= 32 for k in ks)
        early = harness.early_frames(seed, 200, 8)
        assert early[0] == 8 and early[-1] == 16 and len(early) == 3


def test_no_jax_loaded():
    """The harness, its reference and a whole run load no module whose
    top-level name is jax, jaxlib, flax or vloam_tpu (vloam_tpu_torch is
    not vloam_tpu)."""
    code = (
        "import sys, torch; torch.set_num_threads(1)\n"
        "from benchmark import run, readings, judge, harness, trace\n"
        "from benchmark.reference import check, frames\n"
        "from benchmark.roofline import work\n"
        "from benchmark.tests import tiny\n"
        "res = run.measure(tiny.cell(chunk=2), 1, 0.2, False, 'cpu')\n"
        "assert 'vloam_tpu_torch' in sys.modules and res['correct']\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "vloam_tpu_torch_x", sys)
    assert "vloam_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vloam_tpu.lidar", sys)
    assert "vloam_tpu" in run.forbidden_modules()


@pytest.mark.cuda
def test_cell_on_the_card():
    """hdl64_lo.stream on the card, a short window: correct, with every
    end-to-end metric, the device's time a frame above 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "hdl64_lo.stream",
         "--seed", "4000000007", "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and set(res["metrics"]) == {"device_ms_per_frame",
                                                      "setup_s"}
    assert res["metrics"]["device_ms_per_frame"]["value"] > 0
