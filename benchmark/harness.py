"""The benchmark's cells: configurations, traffic, engines and the window.

Everything here is found by name from `BENCHMARK.json`:
- `configs/<config>.json`: the deployment (the engines' configuration tree
  under "pipeline", the range image's width and unit, the camera);
- `traffic/<mix>.json`: the drives (streams, circuit, scene, noise);
- `cells/<cell>.json`: the engine's chunk, the frames the reference checks
  and the limits of each number compared;
- `metrics/<metric>.py`: one reader a per-layer metric.

A cell's engine follows from its configuration and traffic: one stream
without a camera is `LoamEngine`, with one `VloamEngine`; several streams
are `BatchLoamEngine`, pushed in lockstep, stream by stream.
"""

from __future__ import annotations

import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of BENCHMARK.json with the files it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    params: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def streams(self) -> int:
        return int(self.traffic["streams"])

    @property
    def camera(self) -> dict | None:
        return self.config.get("camera")

    @property
    def chunk(self) -> int:
        return int(self.params["chunk"])


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec: dict | None = None) -> Cell:
    spec = spec or load_json(ROOT / "BENCHMARK.json")
    w = next((w for w in spec["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(ROOT / conf["file"]),
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        params=load_json(BENCH / "cells" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def namespace(d):
    """A nested dict as attributes (the reference reads its configuration
    that way)."""
    if isinstance(d, dict):
        return SimpleNamespace(**{k: namespace(v) for k, v in d.items()})
    return d


def port_config(pipeline: dict):
    """The port's PipelineConfig holding every key of `pipeline`."""
    from vloam_tpu_torch import config as C

    return C.PipelineConfig(
        detach_VO_LO=pipeline["detach_VO_LO"],
        lidar=C.LidarProfile(**pipeline["lidar"]),
        scanreg=C.ScanRegistrationConfig(**pipeline["scanreg"]),
        lo=C.LaserOdometryConfig(**pipeline["lo"]),
        mapping=C.LaserMappingConfig(**pipeline["mapping"]),
        vo=C.VisualOdometryConfig(**pipeline["vo"]))


class Calib:
    """The rig's calibration as the combined engine reads it: K, the
    velodyne -> image projection, imu_T_velo (the identity: the velodyne is
    the body frame) and imu_T_cam0."""

    def __init__(self, camera: dict):
        self.K = np.asarray(camera["K"], np.float64)
        self.imu_T_cam0 = np.asarray(camera["velo_T_cam"], np.float64)
        self.imu_T_velo = np.eye(4)
        P_rect0 = np.hstack([self.K, np.zeros((3, 1))])
        self.P_velo_to_img = P_rect0 @ np.linalg.inv(self.imu_T_cam0)


def make_drives(cell: Cell, seed: int, device) -> list:
    """The cell's drives from the seed, made on `device` and copied to the
    host: stream b of a lockstep mix is seeded (seed, b)."""
    from .traffic.drive import make_drive

    cam = cell.camera
    camera = (None if cam is None else
              (np.asarray(cam["K"]), np.asarray(cam["velo_T_cam"]),
               cam["width"], cam["height"]))
    lidar = cell.config["pipeline"]["lidar"]
    t = dict(cell.traffic, range_scale_m=cell.config["range_scale_m"])
    seeds = [seed] if cell.streams == 1 else [(seed, b) for b in
                                              range(cell.streams)]
    return [make_drive(s, t, lidar["n_scans"], cell.config["n_azimuth"],
                       device, camera) for s in seeds]


class Feed:
    """The cell's engine and its frame feed: push(k) pushes frame k of every
    stream (circuit frame k mod L), timing the engine's push_polar calls;
    finish() returns the rows [streams, N, D]."""

    def __init__(self, cell: Cell, cfg, drives, device):
        from vloam_tpu_torch.lidar.loam_step import BatchLoamEngine, LoamEngine
        from vloam_tpu_torch.vloam_step import VloamEngine

        from .traffic.drive import hdl64_elevations

        self.cell, self.drives = cell, drives
        self.scale = cell.config["range_scale_m"]
        self.elev = hdl64_elevations(cfg.lidar.n_scans)
        e = cell.params.get("engine", {})
        if cell.streams > 1:
            self.engine = BatchLoamEngine(cfg, cell.streams, chunk=cell.chunk,
                                          device=device, **e)
        elif cell.camera is not None:
            self.engine = VloamEngine(cfg, Calib(cell.camera),
                                      chunk=cell.chunk, device=device, **e)
        else:
            self.engine = LoamEngine(cfg, chunk=cell.chunk, device=device,
                                     **e)
        self.push_s = 0.0

    def frame(self, b: int, k: int):
        d = self.drives[b]
        return d.ranges[k % len(d.ranges)]

    def image(self, b: int, k: int):
        d = self.drives[b]
        return d.images[k % len(d.images)]

    def push(self, k: int):
        eng, clock = self.engine, time.perf_counter
        for b in range(self.cell.streams):
            r = self.frame(b, k)
            t0 = clock()
            if self.cell.streams > 1:
                eng.push_polar(b, r, self.scale, self.elev)
            elif self.cell.camera is not None:
                eng.push_polar(r, self.image(b, k), self.scale, self.elev)
            else:
                eng.push_polar(r, self.scale, self.elev)
            self.push_s += clock() - t0

    def finish(self) -> np.ndarray:
        rows = self.engine.finish()
        return rows if rows.ndim == 3 else rows[None]


def run_window(push, k0: int, chunk: int, seconds: float,
               clock=time.perf_counter) -> int:
    """Push frames k0, k0 + 1, ... until `seconds` have passed on `clock`
    and the chunk in hand is full; returns the next frame's index."""
    t0 = clock()
    k = k0
    while True:
        push(k)
        k += 1
        if (k - k0) % chunk == 0 and clock() - t0 >= seconds:
            return k


def load_reader(metric: str):
    """metrics/<metric>.py's read(ctx)."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def checked_frames(seed: int, n_frames: int, n_checked: int,
                   chunk: int) -> list[int]:
    """The frames the reference checks: the first two, the window's first
    (frame `chunk`, after the warm chunk), the first of a later chunk drawn
    from the seed, the last, and n_checked more drawn from the seed."""
    rng = np.random.default_rng((seed, 7))
    starts = np.arange(2 * chunk, n_frames - 1, chunk)
    ks = {0, 1, chunk, n_frames - 1}
    if len(starts):
        ks.add(int(rng.choice(starts)))
    pool = np.arange(2, max(n_frames - 1, 2))
    pick = rng.choice(pool, size=min(n_checked, len(pool)), replace=False)
    ks.update(pick.tolist())
    return sorted(k for k in ks if 0 <= k < n_frames)


def early_frames(seed: int, n_frames: int, chunk: int) -> list[int]:
    """The frames checked in a lockstep stream that the reference does not
    follow to the end: the window's first (frame `chunk`), one drawn from
    the seed inside its first chunk, and the first of the next chunk."""
    rng = np.random.default_rng((seed, 5))
    ks = {chunk, chunk + int(rng.integers(1, max(chunk, 2))), 2 * chunk}
    return sorted(k for k in ks if k < n_frames)


def checked_streams(seed: int, streams: int, n: int) -> list[int]:
    if streams <= n:
        return list(range(streams))
    rng = np.random.default_rng((seed, 11))
    return sorted(rng.choice(streams, size=n, replace=False).tolist())
