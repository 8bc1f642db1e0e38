"""The 500-frame long drive through the port's LiDAR-only engine: the
counterpart of scripts/eval_long.py.

    python -m vloam_tpu_torch.tools.eval_long [--frames N] \
        [--device cuda|cpu] [--out FILE]

LoamEngine(kitti_hdl64(), chunk=16) takes the range images of
tools/eval_frames.long_drive (~600 m, a map recentre every 50 m) through
push_polar: 16 warm-up frames, then the rest timed between two fences. Every
LO and MO output must be finite (it raises otherwise). One JSON line: the
KITTI metrics (step 1) of LO and MO, the drive's length, the map recentre
crossings, the degraded frames (fewer than min_correspondences LO
constraints), the steady frames/s with the card's name and power limit and
the host CPU, and each map grid's live slots and full buckets at the end of
the drive (gridmap.grid_flat_points): whether the drive reached the map's
capacity. --out gets the same line and nothing else is written (no
RESULTS.md). Runs on the card unless --device cpu.
"""

from __future__ import annotations

import time

import numpy as np

from ..eval.kitti_metrics import kitti_metrics
from . import eval_frames


def grid_occupancy(g) -> dict:
    """A map grid's live slots and full buckets (read back to the host)."""
    from ..lidar.gridmap import grid_flat_points

    _, live = grid_flat_points(g)
    live = live.reshape(-1, g.cap)
    return {"live_slots": int(live.sum()),
            "full_buckets": int(live.all(dim=1).sum()),
            "buckets": live.shape[0], "cap": g.cap}


def run(frames, gt, cfg, device, chunk: int = 16,
        warm: int = 16) -> tuple[dict, dict]:
    """The drive through LoamEngine, `warm` frames before the timed ones
    (at least one is timed); returns the JSON record and the unpacked
    outputs."""
    from ..geometry.np_pose import qt_to_T
    from ..lidar.loam_step import LoamEngine, unpack_outputs
    from .bench import _fence

    warm = min(warm, len(frames) - 1)
    eng = LoamEngine(cfg, chunk=chunk, device=device)
    for f in frames[:warm]:
        eng.push_polar(f)
    _fence(eng.device)
    t0 = time.perf_counter()
    for f in frames[warm:]:
        eng.push_polar(f)
    _fence(eng.device)
    fps = (len(frames) - warm) / (time.perf_counter() - t0)
    outs = eng.finish()
    if len(outs) != len(frames):
        raise RuntimeError(f"{len(outs)} output rows for {len(frames)} "
                           "frames")
    raw = unpack_outputs(outs)
    for key in ("t_w_mo", "q_w_mo", "t_w_lo", "q_w_lo"):
        if not np.isfinite(raw[key]).all():
            raise RuntimeError(f"the long drive's {key} is not finite")
    dist = float(np.linalg.norm(np.diff(gt[:, :, 3], axis=0), axis=1).sum())
    rec = {"eval": "long", "frames": len(frames), "chunk": chunk,
           "distance_m": dist,
           "crossings": int(dist // cfg.mapping.cube_size),
           "degraded_frames": len(raw["lo_degraded"]),
           "metrics": {w: kitti_metrics(gt, qt_to_T(
               raw[f"q_w_{w.lower()}"], raw[f"t_w_{w.lower()}"])[:, :3, :],
               step=1) for w in ("LO", "MO")},
           "fps_steady": fps,
           "map": {name: grid_occupancy(getattr(eng.state.cube, name))
                   for name in ("corner", "surf")},
           **eval_frames.stamp(eng.device)}
    return rec, raw


def main(argv=None, cfg=None, n_scans: int = 64, n_azimuth: int = 1800,
         workers: int | None = None) -> int:
    """The command line; cfg, n_scans, n_azimuth and workers size the drive
    (kitti_hdl64() and the script's 64 x 1800 by default)."""
    from ..config import kitti_hdl64
    from ..lidar.loam_step import engine_device

    args = eval_frames.tool_parser("vloam_tpu_torch.tools.eval_long", 500,
                                   __doc__.split("\n\n")[0]).parse_args(argv)
    device = engine_device(args.device)
    frames, gt = eval_frames.long_drive(args.frames, n_scans, n_azimuth,
                                        workers)
    report = eval_frames.Report(args.out)
    report.line(run(frames, gt, cfg or kitti_hdl64(), device)[0])
    report.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
