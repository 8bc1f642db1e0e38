"""The roofline's frozen work arithmetic (benchmark/roofline) against the
port's own (vloam_tpu_torch/tools/work.py and tools/timing.py), on counted
frames of the small test profile, on the CPU."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from benchmark import harness
from benchmark.reference import check, frames
from benchmark.roofline import peaks, work
from benchmark.tests import tiny
from benchmark.traffic.drive import hdl64_elevations


@pytest.fixture(scope="module")
def counted():
    """Three frames of a tiny drive: the port's counting pass and the
    benchmark's counts from its reference pass over a LoamEngine's rows."""
    from vloam_tpu_torch.lidar.loam_step import LoamEngine
    from vloam_tpu_torch.tools import work as port_work

    cell = tiny.cell()
    cfg = harness.port_config(cell.config["pipeline"])
    d = harness.make_drives(cell, 11, "cpu")[0]
    elev = hdl64_elevations(cfg.lidar.n_scans)
    eng = LoamEngine(cfg, chunk=3, device="cpu")
    for k in range(3):
        eng.push_polar(d.ranges[k], 0.005, elev)
    rows = eng.finish()
    ns = harness.namespace(cell.config["pipeline"])
    sensor = frames.Sensor.create(elev, cell.config["n_azimuth"],
                                  ns.vo.polar_fov_fraction, "cpu")
    mine = []

    def visit(k, c):
        mine.append(work.frame_counts(
            ns, d.ranges[k], c["q_off"], c["t_off"], c["last_slabs"],
            c["map_before"], c["map_after"], c["feats"], c["stacks"],
            c["row"]))

    check.follow(rows, lambda k: d.ranges[k], ns, sensor, 0.005, [2], "cpu",
                 visit=visit)
    return cfg, ns, port_work.count_frames(cfg, list(d.ranges[:3]), "cpu"), \
        mine


def test_counts_equal_the_ports(counted):
    _, _, port, mine = counted
    for a, b in zip(port, mine):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert mine[2].lo_corner > 0 and mine[2].probe_rows_s > 0


def test_frame_work_equals_the_ports(counted):
    from vloam_tpu_torch.tools import work as port_work

    cfg, ns, port, mine = counted
    for a, b in zip(port, mine):
        assert port_work.frame_work(cfg, a) == work.frame_work(ns, b)
    assert (port_work.mean_work([port_work.frame_work(cfg, c) for c in port])
            == work.mean_work([work.frame_work(ns, c) for c in mine]))


def test_peaks_equal_the_ports():
    from vloam_tpu_torch.tools import timing

    assert peaks.H100_BYTES_PER_S == timing.H100_BYTES_PER_S
    assert peaks.H100_FP32_OPS_PER_S == timing.H100_FP32_OPS_PER_S
    assert peaks.H100_FP64_OPS_PER_S == timing.H100_FP64_OPS_PER_S
    w = {"ops": 6.5e8, "ops_f64": 2e7, "bytes": 3.5e6}
    r = timing.roofline(w["ops"], w["ops_f64"], w["bytes"], 10.0)
    np.testing.assert_allclose(
        peaks.least_seconds(w["ops"], w["ops_f64"], w["bytes"]) * 1e3,
        r["bound_ms"], rtol=1e-12)
