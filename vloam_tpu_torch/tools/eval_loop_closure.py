"""The 320-frame closed circle through the port's LiDAR-only engine, with
and without loop closure: the counterpart of scripts/eval_loop_closure.py.

    python -m vloam_tpu_torch.tools.eval_loop_closure [--frames N] \
        [--device cuda|cpu] [--out FILE]

LoamEngine(kitti_hdl64(), chunk=16) takes the points of
tools/eval_frames.loop_drive; then backend.loop_closure.close_loops (radius
22 m, min_gap 40, 12 candidates, loop weight 8) closes the LO chain and the
MO chain in turn. One JSON line a chain: its KITTI metrics (step 1) before
and after loop closure, the loops found, the seconds close_loops took and
the engine's seconds for the drive, with the card's name and power limit
and the host CPU. --out gets the same lines and nothing else is written (no
RESULTS.md). Runs on the card unless --device cpu.
"""

from __future__ import annotations

import time

import numpy as np

from ..eval.kitti_metrics import kitti_metrics
from . import eval_frames

# close_loops' arguments in the script
LOOP_ARGS = dict(radius=22.0, min_gap=40, max_candidates=12, loop_weight=8.0)


def run(scans, gt, cfg, device, chunk: int = 16,
        loop_args=None) -> list[tuple[dict, dict]]:
    """The drive, then close_loops on LO and on MO; returns per chain its
    JSON record and close_loops' result."""
    from ..backend.loop_closure import close_loops
    from ..data.synthetic import pad_scan
    from ..geometry.np_pose import inv_T, qt_to_T
    from ..lidar.loam_step import LoamEngine, unpack_outputs

    eng = LoamEngine(cfg, chunk=chunk, device=device)
    t0 = time.perf_counter()
    for s in scans:
        eng.push(s)
    raw = unpack_outputs(eng.finish())
    drive_s = time.perf_counter() - t0

    def get_scan(k):
        return pad_scan(scans[k], cfg.lidar.max_points)

    out = []
    for name in ("LO", "MO"):
        q_w, t_w = raw[f"q_w_{name.lower()}"], raw[f"t_w_{name.lower()}"]
        before = kitti_metrics(gt, qt_to_T(q_w, t_w)[:, :3, :], step=1)
        t0 = time.perf_counter()
        res = close_loops(q_w, t_w, get_scan, cfg, device=device,
                          **(loop_args or LOOP_ARGS))
        closing_s = time.perf_counter() - t0
        opt = np.asarray(res["poses"], np.float64)
        lc = qt_to_T(opt[:, :4], opt[:, 4:])
        lc = np.einsum("ij,njk->nik", inv_T(lc[0]), lc)[:, :3, :]
        rec = {"eval": "loop_closure", "chain": name, "frames": len(scans),
               "chunk": chunk, "metrics": before,
               "metrics_closed": kitti_metrics(gt, lc, step=1),
               "loops": [list(map(int, p)) for p in res["loops"]],
               "close_loops_s": closing_s, "drive_s": drive_s,
               **eval_frames.stamp(eng.device)}
        out.append((rec, res))
    return out


def main(argv=None, cfg=None, n_scans: int = 64, n_azimuth: int = 1800,
         workers: int | None = None) -> int:
    """The command line; cfg, n_scans, n_azimuth and workers size the drive
    (kitti_hdl64() and the script's 64 x 1800 by default)."""
    from ..config import kitti_hdl64
    from ..lidar.loam_step import engine_device

    args = eval_frames.tool_parser("vloam_tpu_torch.tools.eval_loop_closure",
                                   320, __doc__.split("\n\n")[0]).parse_args(
                                       argv)
    device = engine_device(args.device)
    scans, gt = eval_frames.loop_drive(args.frames, n_scans, n_azimuth,
                                       workers)
    report = eval_frames.Report(args.out)
    for rec, _ in run(scans, gt, cfg or kitti_hdl64(), device):
        report.line(rec)
    report.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
