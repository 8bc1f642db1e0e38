"""Did a change move the engines' outputs? Drive the three engines over a
short synthetic kitti_hdl64 drive on the GPU and save their raw output rows,
or compare two such files.

    python -m vloam_tpu_torch.tools.trajectories save new.npz
    python -m vloam_tpu_torch.tools.trajectories diff old.npz new.npz

A kernel that stays bit-identical to its plain version must leave every row
as it was: ``diff`` prints the largest absolute difference per engine and
exits nonzero if any row of the LiDAR engines moved (the combined engine's
depth grid adds with atomics, so its rows may differ in the last bits from
run to run; its difference is printed, not gated).

To save the rows of another checkout of the package, run this file by path
with that checkout first on PYTHONPATH:

    PYTHONPATH=/path/to/other python vloam_tpu_torch/tools/trajectories.py \\
        save old.npz
"""

from __future__ import annotations

import sys

import numpy as np

N_FRAMES = 10  # LiDAR-only drive
N_COMBINED = 4  # frames with rendered 1242 x 375 images
N_BATCH = (2, 6)  # streams, lockstep frames
N_AZ = 1800
IMG_W, IMG_H = 1242, 375


def save(path: str) -> None:
    import torch

    from vloam_tpu_torch.config import kitti_hdl64
    from vloam_tpu_torch.data import synthetic
    from vloam_tpu_torch.lidar.loam_step import BatchLoamEngine, LoamEngine
    from vloam_tpu_torch.vloam_step import VloamEngine

    if not torch.cuda.is_available():
        raise RuntimeError("this comparison needs a GPU: "
                           "torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = kitti_hdl64()
    scene = synthetic.urban_scene(0, extent=80.0)
    poses = synthetic.drive_trajectory(N_FRAMES, speed=1.1, yaw_rate=0.01)
    frames = [synthetic.simulate_scan_polar(scene, T, n_scans=64,
                                            n_azimuth=N_AZ, noise=0.01, seed=k)
              for k, T in enumerate(poses)]

    eng = LoamEngine(cfg, chunk=5, device="cuda")
    for f in frames:
        eng.push_polar(f)
    out = {"LoamEngine": eng.finish()}

    nb, nf = N_BATCH
    beng = BatchLoamEngine(cfg, nb, chunk=3, device="cuda")
    for k in range(nf):
        for b in range(nb):
            beng.push_polar(b, frames[k + 2 * b])
    out["BatchLoamEngine"] = beng.finish()

    class Calib:
        pass

    calib = Calib()
    calib.K, P_rect0, _, velo_T_cam = synthetic.default_cam_calib(IMG_W,
                                                                  IMG_H)
    calib.P_velo_to_img = P_rect0 @ np.linalg.inv(velo_T_cam)
    calib.imu_T_velo = np.eye(4)
    calib.imu_T_cam0 = velo_T_cam
    veng = VloamEngine(cfg.replace(detach_VO_LO=False), calib, chunk=2,
                       device="cuda")
    for k in range(N_COMBINED):
        img = synthetic.render_camera(scene, poses[k] @ velo_T_cam, calib.K,
                                      IMG_W, IMG_H)
        veng.push_polar(frames[k],
                        np.clip(img * 255.0, 0, 255).astype(np.uint8))
    out["VloamEngine"] = veng.finish()
    if not all(np.isfinite(v).all() for v in out.values()):
        raise RuntimeError("an engine's output is not finite")
    np.savez(path, **out)
    print(f"saved {', '.join(f'{k} {v.shape}' for k, v in out.items())} to "
          f"{path}", flush=True)


def diff(a_path: str, b_path: str) -> int:
    a, b = np.load(a_path), np.load(b_path)
    moved = 0
    for name in a.files:
        d = float(np.abs(a[name] - b[name]).max())
        same = np.array_equal(a[name], b[name])
        print(f"{name}: rows {'identical' if same else 'differ'}, largest "
              f"|difference| {d:.3g}", flush=True)
        if not same and name != "VloamEngine":
            moved += 1
    return moved


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "save":
        save(argv[1])
        return 0
    if len(argv) == 3 and argv[0] == "diff":
        return diff(argv[1], argv[2])
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
