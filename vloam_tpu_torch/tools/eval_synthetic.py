"""The 100-frame synthetic street drive through the port's fused engines:
the counterpart of scripts/eval_synthetic.py (and, with --modes lidar_only,
of scripts/bisect_eval.py).

    python -m vloam_tpu_torch.tools.eval_synthetic [--frames N] \
        [--modes lidar_only,combined,lidar_only_polar,combined_polar] \
        [--device cuda|cpu] [--out FILE]

Each mode runs pipeline.run_sequence_fused(chunk=10) twice over the drive
of tools/eval_frames.synthetic_drive (kitti_hdl64(); combined modes with
detach_VO_LO=False and 1242 x 375 camera images; polar modes with range
images in place of points) and prints one JSON line: the KITTI metrics
(step 1) of the script's streams against the exact ground truth, the first
run's and the second (steady) run's frames/s, the card's name and power
limit and the host CPU. --out gets the same lines and nothing else is
written: unlike the script, no RESULTS.md and no golden file. Runs on the
card unless --device cpu.
"""

from __future__ import annotations

from ..eval.kitti_metrics import kitti_metrics
from . import eval_frames

# each mode: (camera, range images, the streams the script scores)
MODES = {
    "lidar_only": (False, False, ("LO", "MO")),
    "combined": (True, False, ("VO", "LO", "MO")),
    "lidar_only_polar": (False, True, ("MO",)),
    "combined_polar": (True, True, ("VO", "MO")),
}


def run_mode(mode: str, calib, frames, gt, cfg, device, chunk: int = 10,
             runs: int = 2) -> tuple[dict, dict]:
    """`runs` runs of run_sequence_fused over the frames; returns the JSON
    record and the first run's result (its trajectories)."""
    from ..pipeline import run_sequence_fused

    with_cam, _, streams = MODES[mode]
    if with_cam:
        cfg = cfg.replace(detach_VO_LO=False)
    results = [run_sequence_fused(cfg, calib, iter(frames),
                                  lidar_only=not with_cam, chunk=chunk,
                                  device=device) for _ in range(runs)]
    rec = {"eval": "synthetic", "mode": mode, "frames": len(frames),
           "chunk": chunk,
           "metrics": {w: kitti_metrics(gt, results[0][w], step=1)
                       for w in streams},
           "fps_first": results[0]["fps"], "fps_steady": results[-1]["fps"],
           **eval_frames.stamp(device)}
    return rec, results[0]


def main(argv=None, cfg=None, n_scans: int = 64, n_azimuth: int = 1800,
         workers: int | None = None) -> int:
    """The command line; cfg, n_scans, n_azimuth and workers size the drive
    (kitti_hdl64() and the script's 64 x 1800 by default)."""
    from ..config import kitti_hdl64
    from ..lidar.loam_step import engine_device

    ap = eval_frames.tool_parser("vloam_tpu_torch.tools.eval_synthetic", 100,
                                 __doc__.split("\n\n")[0])
    ap.add_argument("--modes", default=",".join(MODES),
                    help="comma-separated subset of " + ", ".join(MODES))
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    if unknown := set(modes) - set(MODES):
        ap.error(f"unknown modes {sorted(unknown)}")
    device = engine_device(args.device)
    cfg = cfg or kitti_hdl64()
    report = eval_frames.Report(args.out)
    for mode in modes:
        with_cam, with_polar, _ = MODES[mode]
        calib, frames, gt = eval_frames.synthetic_drive(
            args.frames, cfg, with_cam, with_polar, n_scans, n_azimuth,
            workers)
        report.line(run_mode(mode, calib, frames, gt, cfg, device)[0])
    report.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
