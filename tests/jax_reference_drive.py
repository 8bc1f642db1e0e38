"""The JAX package's LiDAR-only engine on the CPU over the port's evaluation
drives: a reference for tools/eval_synthetic.py and tools/eval_long.py
measured on the same host as the card.

    JAX_PLATFORMS=cpu python tests/jax_reference_drive.py \
        synthetic|long|combined

synthetic: vloam_tpu.lidar.loam_step.LoamEngine(kitti_hdl64(), chunk=10)
over tools/eval_frames.synthetic_drive's 100 point frames (what
scripts/eval_synthetic.py's lidar-only run_sequence_fused drives); long:
chunk 16 over long_drive's 500 range images (scripts/eval_long.py's);
combined: vloam_tpu.vloam_step.VloamEngine(kitti_hdl64() with
detach_VO_LO=False, chunk=10) over the same 100 frames' points and 1242 x
375 camera images (scripts/eval_synthetic.py's combined run_sequence_fused,
tools/eval_synthetic.py's combined mode), its trajectories exported as
run_sequence_fused exports them. The drives are the scripts' own, bit for
bit (tests/test_torch_eval.py). Prints one JSON line: the KITTI metrics
(step 1) of LO and MO (and VO) against the ground truth (the sensor's;
combined: cam0's), the degraded frames and each map grid's live slots and
full buckets at the end; combined adds the VO matches n32 / n22 a frame.
Writes nothing but the temporary directory's frame cache.
"""

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from vloam_tpu.config import kitti_hdl64  # noqa: E402
from vloam_tpu.lidar.gridmap import SENTINEL  # noqa: E402
from vloam_tpu.lidar.loam_step import LoamEngine, unpack_outputs  # noqa: E402
from vloam_tpu_torch.data import synthetic  # noqa: E402
from vloam_tpu_torch.eval.kitti_metrics import kitti_metrics  # noqa: E402
from vloam_tpu_torch.geometry.np_pose import qt_to_T  # noqa: E402
from vloam_tpu_torch.tools import eval_frames  # noqa: E402


def _occupancy(g) -> dict:
    pts = np.asarray(g.pts)
    cap = pts.shape[1] // 3
    live = pts.reshape(-1, 3, cap)[:, 0, :] < SENTINEL * 0.5
    return {"live_slots": int(live.sum()),
            "full_buckets": int(live.all(axis=1).sum())}


def main(drive: str) -> None:
    cfg = kitti_hdl64()
    if drive == "synthetic":
        _, frames, _ = eval_frames.synthetic_drive(100)
        frames = [f["points"] for f in frames]
        n = len(frames)
        k = np.arange(n)
        poses = synthetic.drive_trajectory(n, speed=1.2, yaw_rate=np.where(
            k < n // 4, 0.006, np.where(k < 3 * n // 4, -0.006, 0.006)))
        gt = np.stack([T[:3, :] for T in poses])
        eng = LoamEngine(cfg, chunk=10)
        push = eng.push
    elif drive == "combined":
        return combined(cfg.replace(detach_VO_LO=False))
    else:
        frames, gt = eval_frames.long_drive(500)
        eng = LoamEngine(cfg, chunk=16)
        push = eng.push_polar
    for f in frames:
        push(f)
    raw = unpack_outputs(eng.finish())
    print(json.dumps({
        "reference": "vloam_tpu on the CPU", "drive": drive,
        "frames": len(frames),
        "metrics": {w: kitti_metrics(gt, qt_to_T(
            raw[f"q_w_{w.lower()}"], raw[f"t_w_{w.lower()}"])[:, :3, :],
            step=1) for w in ("LO", "MO")},
        "degraded_frames": len(raw["lo_degraded"]),
        "map": {n: _occupancy(getattr(eng.state.cube, n))
                for n in ("corner", "surf")}}), flush=True)


def combined(cfg) -> None:
    from vloam_tpu.vloam_step import VloamEngine, unpack_vloam_outputs

    calib, frames, gt = eval_frames.synthetic_drive(100, with_cam=True)
    eng = VloamEngine(cfg, calib, chunk=10)
    for f in frames:
        eng.push(f["points"], f["image"])
    raw = unpack_vloam_outputs(eng.finish(), calib,
                               min_correspondences=cfg.lo.min_correspondences)
    print(json.dumps({
        "reference": "vloam_tpu on the CPU", "drive": "combined",
        "frames": len(frames),
        "metrics": {w: kitti_metrics(gt, raw[f"traj_{w}"], step=1)
                    for w in ("VO", "LO", "MO")},
        "degraded_frames": len(raw["lo_degraded"]),
        "n32": raw["n32"].tolist(), "n22": raw["n22"].tolist(),
        "map": {n: _occupancy(getattr(eng.lstate.cube, n))
                for n in ("corner", "surf")}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
