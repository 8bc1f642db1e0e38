"""The feature-poor highway drive (the KITTI seq-01 regime) through the
port's combined engine in four configurations: the counterpart of
scripts/eval_highway.py.

    python -m vloam_tpu_torch.tools.eval_highway [--frames N] \
        [--device cuda|cpu] [--out FILE]

pipeline.run_sequence_fused(chunk=10) over tools/eval_frames.highway_drive
(points and 1242 x 375 camera images at 3.2 m a frame) with kitti_hdl64()
set four ways: detached (detach_VO_LO=True: LO and MO never see the VO);
combined with the min_vo_matches gate on; combined with the gate off
(min_vo_matches=0: the reference's failure mode); combined with the gate on
and the low-texture fallback. One JSON line a configuration: the mean VO
matches (n32 + n22) after frame 0, the frames under the gate, the KITTI
metrics (step 1) of its streams, frames/s with the card's name and power
limit and the host CPU. --out gets the same lines and nothing else is
written (no RESULTS.md). Runs on the card unless --device cpu.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..eval.kitti_metrics import kitti_metrics
from . import eval_frames


def configs(base) -> list[tuple[str, object, tuple[str, ...]]]:
    """The script's four configurations: (name, config, streams scored)."""
    return [
        ("detached", base.replace(detach_VO_LO=True), ("LO", "MO")),
        ("combined (guards on)", base.replace(detach_VO_LO=False),
         ("VO", "LO", "MO")),
        ("combined (guards OFF)", base.replace(
            detach_VO_LO=False,
            vo=dataclasses.replace(base.vo, min_vo_matches=0)),
         ("VO", "LO", "MO")),
        ("combined (guards on + lowtex fallback)", base.replace(
            detach_VO_LO=False,
            vo=dataclasses.replace(base.vo, lowtex_fallback=True)),
         ("VO", "LO", "MO")),
    ]


def run(calib, frames, gt, base, device,
        chunk: int = 10) -> list[tuple[dict, dict]]:
    """The four configurations over the drive; returns, per
    configuration, its JSON record and run_sequence_fused's result."""
    from ..pipeline import run_sequence_fused

    out = []
    for name, cfg, streams in configs(base):
        res = run_sequence_fused(cfg, calib, iter(frames), lidar_only=False,
                                 chunk=chunk, device=device)
        n_match = res["raw"]["n32"] + res["raw"]["n22"]
        rec = {"eval": "highway", "config": name, "frames": len(frames),
               "chunk": chunk, "mean_matches": float(np.mean(n_match[1:])),
               "vo_gate_fired": int(np.sum(
                   n_match[1:] < base.vo.min_vo_matches)),
               "metrics": {w: kitti_metrics(gt, res[w], step=1)
                           for w in streams},
               "fps": res["fps"], **eval_frames.stamp(device)}
        out.append((rec, res))
    return out


def main(argv=None, cfg=None, n_scans: int = 64, n_azimuth: int = 1800,
         workers: int | None = None) -> int:
    """The command line; cfg, n_scans, n_azimuth and workers size the drive
    (kitti_hdl64() and the script's 64 x 1800 by default)."""
    from ..config import kitti_hdl64
    from ..lidar.loam_step import engine_device

    args = eval_frames.tool_parser("vloam_tpu_torch.tools.eval_highway", 80,
                                   __doc__.split("\n\n")[0]).parse_args(argv)
    device = engine_device(args.device)
    cfg = cfg or kitti_hdl64()
    calib, frames, gt = eval_frames.highway_drive(args.frames, cfg, n_scans,
                                                  n_azimuth, workers)
    report = eval_frames.Report(args.out)
    for rec, _ in run(calib, frames, gt, cfg, device):
        report.line(rec)
    report.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
