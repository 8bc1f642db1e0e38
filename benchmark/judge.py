"""The comparison that decides a run's `correct`.

The plain reference (benchmark/reference) follows the run's rows in the
streams drawn from the seed and, at the frames drawn from the seed, works
each result out again (check.py says how). In a lockstep cell every other
stream is followed through the window's first chunk, with LO and MO
checked at its first frame, one drawn from the seed and the next chunk's
first, and has its LO checked at one more frame drawn from the seed; every
stream's LO world poses are checked against their chain. Every number
compared is the largest gap over those frames and streams; each has its
limit in cells/<cell>.json, set from the readings of sound runs of the port
and of the control (PERF.md gives both).
"""

from __future__ import annotations

import numpy as np

from . import harness
from .reference import check, frames
from .roofline import work
from .traffic.drive import hdl64_elevations


class Judge:
    """The reference's view of one run: its streams and frames to check,
    the sensor, the camera and the limits."""

    def __init__(self, cell: harness.Cell, drives, seed: int, n_rows: int,
                 device):
        self.cell, self.drives, self.dev = cell, drives, device
        self.cfg = harness.namespace(cell.config["pipeline"])
        self.scale = cell.config["range_scale_m"]
        self.sensor = frames.Sensor.create(
            hdl64_elevations(self.cfg.lidar.n_scans),
            cell.config["n_azimuth"], self.cfg.vo.polar_fov_fraction, device)
        self.camera = None
        if cell.camera is not None:
            cal = harness.Calib(cell.camera)
            self.camera = frames.Camera.create(cal.K, cal.P_velo_to_img,
                                               cal.imu_T_velo,
                                               cal.imu_T_cam0, device)
        self.limits = cell.params["limits"]
        self.streams = harness.checked_streams(
            seed, cell.streams, int(cell.params.get("checked_streams", 1)))
        self.frames = {b: harness.checked_frames(
            seed + b, n_rows, int(cell.params["checked_frames"]),
            cell.chunk) for b in self.streams}
        rng = np.random.default_rng((seed, 13))
        self.lo_frames = {b: int(rng.integers(1, max(n_rows, 2)))
                          for b in range(cell.streams)
                          if b not in self.streams}
        self.early = {b: harness.early_frames(seed + b, n_rows, cell.chunk)
                      for b in self.lo_frames}

    def _range(self, b):
        d = self.drives[b]
        return lambda k: d.ranges[k % len(d.ranges)]

    def reference(self, rows: np.ndarray, precision: str = "float32",
                  counted=range(0)):
        """{b: {k: reference row}} following rows [streams, N, D], and the
        roofline's FrameCounts of the frames `counted` in the streams
        followed."""
        counts, out = [], {}
        lockstep = self.cell.streams if self.cell.streams > 1 else 0
        for b in self.streams:
            d = self.drives[b]

            def visit(k, c, d=d):
                if k in counted:
                    counts.append(work.frame_counts(
                        self.cfg, d.ranges[k % len(d.ranges)], c["q_off"],
                        c["t_off"], c["last_slabs"], c["map_before"],
                        c["map_after"], c["feats"], c["stacks"], c["row"]))

            out[b] = check.follow(
                rows[b], self._range(b), self.cfg, self.sensor, self.scale,
                self.frames[b], self.dev, precision, camera=self.camera,
                image=(None if self.camera is None
                       else lambda k, d=d: d.images[k % len(d.images)]),
                visit=visit if len(counted) else None, streams=lockstep)
        for b, k in self.lo_frames.items():
            out[b] = check.follow(rows[b], self._range(b), self.cfg,
                                  self.sensor, self.scale, self.early[b],
                                  self.dev, precision, streams=lockstep)
            for j, row in check.lo_at(rows[b], self._range(b), self.cfg,
                                      self.sensor, self.scale, k, self.dev,
                                      precision).items():
                out[b].setdefault(j, row)
        return out, counts

    def gaps(self, got: dict, ref: dict) -> dict:
        """{name: gaps [frames]} over the checked streams and frames between
        got[b][k] and ref[b][k] (NaN where a number was not computed)."""
        per: dict[str, list] = {}
        for b in sorted(ref):
            g = check.compare(got[b], ref[b], self.camera is not None,
                              per_frame=True)
            for name, v in g.items():
                per.setdefault(name, []).extend(np.asarray(v).tolist())
        return {k: np.asarray(v, np.float64) for k, v in per.items()}

    def chain_gap(self, rows: np.ndarray) -> float:
        return max(check.world_chain_gap(rows[b], self.dev)
                   for b in range(rows.shape[0]))

    def readings(self, rows: np.ndarray, counted=range(0)):
        """The run's numbers compared (the largest gap of each), the frames
        over a limit, and the roofline's counts."""
        ref, counts = self.reference(rows, counted=counted)
        got = {b: {k: rows[b, k] for k in ref[b]} for b in ref}
        per = self.gaps(got, ref)
        over = np.zeros(len(next(iter(per.values()))), bool)
        for name, v in per.items():
            over |= np.nan_to_num(v, nan=0.0) > self.limits[name]
        values = {name: float(np.nanmax(v)) for name, v in per.items()}
        values["world_chain_gap_m"] = self.chain_gap(rows)
        return values, int(over.sum()), counts
