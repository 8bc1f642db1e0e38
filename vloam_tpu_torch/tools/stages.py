"""The table the stage profilers print (tools/profile_stages.py,
profile_vision_stages.py, profile_batch_stages.py) and the frames they build.

Each stage is a call that queues its work and returns; StageTable.stage runs
it once for its outputs (which the next stage takes) and then times it with
timing.stage_clocks: the host's enqueue, the wall with a synchronize, the
device time of its kernels replayed from a CUDA graph, the graph's kernel
nodes and the hand-written kernels' launches. A line a stage carries the
port's label, the JAX script's label and shape for that stage, and the
clocks (on the CPU the two host clocks only). Sections are headed by the
JAX script they port. The last line a tool prints is one JSON object: every
stage's clocks and the checks (launches of stages summed against their
frame's; each stage's hand-kernel launches against the engines').

The frames are the JAX scripts': urban_scene(0, extent=80) along
drive_trajectory(n, speed=1.1, yaw_rate=0.01), frame k seeded k with 1 cm
of range noise (polar range images at 5 mm, or xyz scans padded to the
profile's max_points), and the cam0 images rendered along the same poses;
made in worker processes and cached in the temporary directory
(tools/bench.py's cache).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from .timing import card_line, stage_clocks

REPO = Path(__file__).resolve().parents[2]
TINY_AZIMUTH = 360  # the CPU tests' range images: 16 rings x 360 columns


def profile(tiny: bool):
    """(cfg, azimuth columns): kitti_hdl64() at 1800, or the tests' tiny
    profile at 360."""
    from ..config import kitti_hdl64, tiny_test_profile

    return ((tiny_test_profile(), TINY_AZIMUTH) if tiny
            else (kitti_hdl64(), 1800))


def _xyz_scan(args):
    """An xyz scan of urban_scene(0, extent=80) from pose T, padded to cap
    (the scripts' simulate_scan + pad_scan)."""
    from ..data import synthetic

    T, seed, n_scans, n_az, cap = args
    pts = synthetic.simulate_scan(synthetic.urban_scene(0, extent=80.0), T,
                                  n_scans=n_scans, n_azimuth=n_az,
                                  noise=0.01, seed=seed)
    return synthetic.pad_scan(pts, cap)[0]


def workers(tiny: bool) -> int:
    """Frame-making processes: none at the tiny profile (its frames take
    milliseconds), else up to 8."""
    return 1 if tiny else max(1, min(8, os.cpu_count() or 1))


def drive_frames(n: int, n_scans: int, n_az: int,
                 workers: int) -> list[np.ndarray]:
    """Polar range images [n_scans, n_az] uint16 of the scripts' drive."""
    from ..data import synthetic
    from .bench import _cached, _pool_map, _scan

    poses = synthetic.drive_trajectory(n, speed=1.1, yaw_rate=0.01)
    return _cached(f"stages_polar_{n}", (0, 80.0, n_scans, n_az, 0.01, 1.1,
                                         0.01, n),
                   lambda: _pool_map(_scan, [(T, k, n_scans, n_az, 0, 0.005)
                                             for k, T in enumerate(poses)],
                                     min(n, workers)))


def xyz_frames(poses, seeds, n_scans: int, n_az: int,
               cap: int) -> list[np.ndarray]:
    """xyz scans [cap, 3] float32 from the given poses and seeds (the tools
    take at most 3, which is faster in this process than in workers)."""
    from .bench import _cached

    key = tuple(np.round(np.asarray(poses), 9).ravel().tolist())
    return _cached(f"stages_xyz_{len(poses)}",
                   (0, 80.0, n_scans, n_az, 0.01, cap, tuple(seeds), key),
                   lambda: [_xyz_scan((T, s, n_scans, n_az, cap))
                            for T, s in zip(poses, seeds)])


def camera_images(poses, w: int, h: int, workers: int) -> list[np.ndarray]:
    """cam0 images [h, w] uint8 rendered from the sensor poses (the
    synthetic rig: imu_T_cam0 = velo_T_cam)."""
    from .bench import _cached, _Calib, _image, _pool_map

    calib = _Calib(w, h)
    key = tuple(np.round(np.asarray(poses), 9).ravel().tolist())
    return _cached(f"stages_images_{len(poses)}", (0, 80.0, w, h, key),
                   lambda: _pool_map(_image, [(T @ calib.imu_T_cam0, calib.K,
                                               w, h) for T in poses],
                                     min(len(poses), workers)))


def n_points(scan: np.ndarray) -> int:
    """The returns a padded xyz scan holds (pad_scan zero-fills the tail)."""
    return int(np.count_nonzero(np.any(scan != 0, axis=1)))


def hand_text(hand) -> str:
    return ", ".join(f"{k} {v}" for k, v in sorted(hand.items())) or "none"


class StageTable:
    """Stages timed one by one and printed as they finish; result() is the
    JSON record."""

    def __init__(self, tool: str, device, runs: int, replays: int,
                 tiny: bool):
        self.tool = tool
        self.device = torch.device(device)
        self.runs = runs
        self.replays = replays
        self.rows: list[dict] = []
        self.sections: list[dict] = []
        self.checks: dict[str, list] = {"sums": [], "hand": []}
        self.extra: dict = {}
        self.card = (card_line() if self.device.type == "cuda" else "cpu")
        self.tiny = tiny
        self._t_section = None
        self._t0 = time.perf_counter()
        print(f"[{tool}] device {self.card}; profile "
              f"{'tiny_test_profile' if tiny else 'kitti_hdl64'}; host clocks "
              f"the mean of {runs} call(s) after a warm-up; device: "
              f"{replays} graph replays (warm L2)", flush=True)

    def section(self, scripts: tuple[str, ...], what: str) -> None:
        """Open the section that ports the JAX scripts `scripts`
        (scripts/...py)."""
        self.end_section()
        self._t_section = time.perf_counter()
        lines = {s: len((REPO / s).read_text().splitlines())
                 for s in scripts}
        self.sections.append({"scripts": list(scripts), "what": what})
        print(f"== {', '.join(f'{s} ({n} lines)' for s, n in lines.items())}"
              f": {what}", flush=True)

    def end_section(self) -> None:
        """Print the open section's seconds (frames made before it not
        counted)."""
        if self._t_section is not None:
            dt = time.perf_counter() - self._t_section
            self.sections[-1]["seconds"] = dt
            self.note(f"section in {dt:.1f} s")
            self._t_section = None

    def note(self, text: str) -> None:
        print(f"   {text}", flush=True)

    def stage(self, label: str, fn, jax: str = "", shape: str = "",
              expect: dict | None = None, key: str | None = None):
        """Run fn() for its outputs, time it, print its line; returns the
        outputs. expect: the hand-written kernels' launches the engines make
        in this stage (kernel -> count, checked on the card). key: the name
        sum checks use (the label by default)."""
        out = fn()
        clk = stage_clocks(fn, self.runs, self.device, self.replays,
                           warm=False)
        row = {"section": len(self.sections) - 1, "label": label,
               "key": key or label, "jax": jax, "shape": shape, **clk}
        self.rows.append(row)
        text = (f"  {label:46s} host {clk['host_ms']:9.3f} ms, wall "
                f"{clk['wall_ms']:9.3f} ms")
        if clk["device_ms"] is not None:
            text += (f", device {clk['device_ms']:8.3f} ms "
                     f"({clk['device_how']}), launches {clk['launches']} "
                     f"({clk['launches_how']}), hand "
                     f"{hand_text(clk['hand'])}")
        if clk["capture_error"]:
            text += f"; NOT CAPTURED: {clk['capture_error']}"
        if jax or shape:
            text += f"  | JAX: {jax} {shape}".rstrip()
        print(text, flush=True)
        if expect is not None and clk["hand"] is not None:
            ok = clk["hand"] == {k: v for k, v in expect.items() if v}
            self.checks["hand"].append({"stage": row["key"], "want": expect,
                                        "got": clk["hand"], "ok": ok})
            if not ok:
                print(f"   hand-written kernels in {label}: "
                      f"{hand_text(clk['hand'])}, the engines make "
                      f"{hand_text(expect)}", flush=True)
        return out

    def row(self, key: str) -> dict:
        return next(r for r in self.rows if r["key"] == key)

    def sum_check(self, name: str, parts: list[str], whole: str) -> None:
        """The launches of the stages `parts` against the stage `whole`
        (on the card: both from captured graphs' kernel nodes)."""
        rows = [self.row(k) for k in parts]
        w = self.row(whole)
        if w["launches"] is None:
            return
        total = sum(r["launches"] for r in rows)
        rec = {"name": name, "parts": {r["key"]: r["launches"]
                                       for r in rows},
               "sum": total, "whole": w["launches"],
               "ok": total == w["launches"],
               "captured": all(not r["capture_error"] for r in rows + [w]),
               "device_ms_sum": sum(r["device_ms"] for r in rows),
               "device_ms_whole": w["device_ms"],
               "host_ms_sum": sum(r["host_ms"] for r in rows),
               "host_ms_whole": w["host_ms"]}
        self.checks["sums"].append(rec)
        print(f"   {name}: the stages' launches sum to {total}, the whole "
              f"frame's are {w['launches']} "
              f"({'equal' if rec['ok'] else 'NOT EQUAL'}); device "
              f"{rec['device_ms_sum']:.3f} ms summed, "
              f"{w['device_ms']:.3f} ms whole; host enqueue "
              f"{rec['host_ms_sum']:.3f} ms summed, {w['host_ms']:.3f} whole",
              flush=True)

    def result(self) -> dict:
        self.end_section()
        self.note(f"{self.tool} in {time.perf_counter() - self._t0:.1f} s "
                  "(its frames made or read included)")
        return {"tool": self.tool, "device": self.card,
                "profile": "tiny_test_profile" if self.tiny else "kitti_hdl64",
                "runs": self.runs, "replays": self.replays,
                "sections": self.sections, "stages": self.rows,
                "checks": self.checks, **self.extra}


def parse(prog: str, doc: str, argv):
    """The tools' common command line."""
    import argparse

    ap = argparse.ArgumentParser(prog=prog, description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu: the CPU gives the host "
                    "clocks only")
    ap.add_argument("--tiny", action="store_true",
                    help="the tests' tiny profile (16 rings x 360) instead "
                    "of kitti_hdl64 at 64 x 1800")
    ap.add_argument("--runs", type=int, default=3,
                    help="host-clock calls a stage (default 3)")
    ap.add_argument("--replays", type=int, default=20,
                    help="graph replays a stage's device time (default 20)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="frames a chunk where a script times chunks "
                    "(default 8, the scripts')")
    return ap.parse_args(argv)


def emit(rec: dict) -> None:
    """The record as the tool's last line."""
    print(json.dumps(rec), flush=True)
