"""VO accuracy diagnosis on the synthetic evaluation drive (port of
scripts/diag_vo.py): for each frame pair, match quality against ground
truth, depth association and the frame-to-frame solve's error, and five
ablations.

    python -m vloam_tpu_torch.tools.diag_vo [--device cpu]
        [--entry main|ablate|error_anatomy|family_ablation|
                 improve_ablation|improve_ablation2|all] [--pairs N]

Entry points, each with the script's variants and printed statistics:
  main: base (ZNCC, brute force, ratio test) and lk-flow; per variant the
    mean valid matches, n32 and n22, the matches' reprojection median and
    share under 2 px (the previous pixel at its queried depth moved by the
    true motion), the rotation (mrad) and translation (mm) error, and the
    translation error pair by pair.
  ablate: keypoint count / quality, ratio, depth neighbours and radius, LM
    iterations, bucket NMS; mean errors, n32, n22.
  error_anatomy: the translation error's camera-frame components (z is
    forward) with the LiDAR depth grid and with a ground-truth grid (the
    true depth raycast through each live cell's centre, data/synthetic.py's
    _ray_scene_range).
  family_ablation: subpixel corners, the 3D-2D (n32) or 2D-2D (n22)
    residuals alone.
  improve_ablation, improve_ablation2: subpixel, the depth-spread gate,
    Huber delta, nn matching, ratio, patch size.

The frames are tools/eval_frames.py's 100-frame drive (scripts/
eval_synthetic.py's S-curve street, the frames its cache holds), its first
N + 1 frames (points and 1242 x 375 images); the truth is that drive's own
(the script paired an older cache with drive_trajectory(N + 1, 1.2, 0.008)
and urban_scene(0, 140, 24, 32), a world its frames no longer come from).
The stages are the port's (vision/features.py with K3, depth_map.py, vo.py
with K inverted once on the host, optical_flow.py), on the card unless
--device cpu. Each entry point ends with a JSON line of its numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from ..vision import features
from ..vision.depth_map import DepthGrid, build_depth_grid, query_depth
from ..vision.optical_flow import lk_flow
from ..vision.vo import solve_vo

DRIVE_FRAMES = 100  # the evaluation drive the pairs are taken from
ENTRIES = ("main", "ablate", "error_anatomy", "family_ablation",
           "improve_ablation", "improve_ablation2")
ABLATE = {
    "base": {},
    "kp2048_q01": {"max_keypoints": 2048, "shi_tomasi_quality": 0.01},
    "kp2048_q01_r85": {"max_keypoints": 2048, "shi_tomasi_quality": 0.01,
                       "match_ratio": 0.85},
    "ratio85": {"match_ratio": 0.85},
    "ratio90": {"match_ratio": 0.9},
    "depth_nb5": {"min_depth_neighbors": 5},
    "depth_r3": {"depth_search_radius": 3},
    "iters64": {"max_iterations": 64},
    "nms_on": {"keypoint_nms": True, "nms_max_total": 1024,
               "max_keypoints": 2048, "shi_tomasi_quality": 0.01},
}
FAMILY = {  # name: (config changes, residual family kept)
    "base": ({}, None),
    "subpixel": ({"subpixel": True}, None),
    "only32": ({}, "32"),
    "only22": ({}, "22"),
    "subpix_only32": ({"subpixel": True}, "32"),
}
IMPROVE = {
    "base": {},
    "subpix": {"subpixel": True},
    "spread1": {"max_depth_spread": 1.0},
    "spread2": {"max_depth_spread": 2.0},
    "spread05": {"max_depth_spread": 0.5},
    "subpix+spread1": {"subpixel": True, "max_depth_spread": 1.0},
    "subpix+spread1+kp2048": {"subpixel": True, "max_depth_spread": 1.0,
                              "max_keypoints": 2048,
                              "shi_tomasi_quality": 0.01},
}
IMPROVE2 = {
    "subpix": {"subpixel": True},
    "subpix_h05": {"subpixel": True, "huber_delta": 0.05},
    "subpix_h02": {"subpixel": True, "huber_delta": 0.02},
    "subpix_nn": {"subpixel": True, "match_select": "nn"},
    "subpix_r75": {"subpixel": True, "match_ratio": 0.75},
    "subpix_patch24": {"subpixel": True, "descriptor_patch": 24},
}


class Drive:
    """The pairs' inputs on a device: images, points, cam0 poses (world,
    4 x 4), K and its host inverse, P_velo_to_img, the scene (for the
    ground-truth raycast)."""

    def __init__(self, frames, cam_poses, calib, scene, device):
        self.device = torch.device(device)
        self.frames = frames
        self.cam_poses = cam_poses
        self.calib = calib
        self.K = np.asarray(calib.K, np.float64)
        self.Kinv = self.t(np.linalg.inv(np.asarray(calib.K, np.float32)))
        self.P = self.t(calib.P_velo_to_img)
        self.scene = scene

    def t(self, x) -> torch.Tensor:
        return torch.tensor(np.asarray(x), dtype=torch.float32,
                            device=self.device)

    @property
    def n_pairs(self) -> int:
        return len(self.frames) - 1

    def head(self, n_pairs: int) -> "Drive":
        """The drive's first n_pairs pairs."""
        return Drive(self.frames[:n_pairs + 1],
                     self.cam_poses[:n_pairs + 1], self.calib, self.scene,
                     self.device)

    def image(self, k: int) -> torch.Tensor:
        return self.t(self.frames[k]["image"])

    def grid(self, k: int, vo) -> DepthGrid:
        pts = self.frames[k]["points"]
        return build_depth_grid(
            self.t(pts), torch.ones(len(pts), dtype=torch.bool,
                                    device=self.device), self.P, vo)

    def truth(self, k: int) -> np.ndarray:
        """cam0 motion from frame k to k + 1 (maps frame-k camera points
        into frame k + 1)."""
        return np.linalg.inv(self.cam_poses[k + 1]) @ self.cam_poses[k]


def load_drive(n_pairs: int, cfg, device, n_frames: int = DRIVE_FRAMES,
               n_scans: int = 64, n_azimuth: int = 1800,
               workers: int | None = None) -> Drive:
    """The first n_pairs + 1 frames of the n_frames evaluation drive."""
    from . import eval_frames

    calib, frames, _ = eval_frames.synthetic_drive(
        n_frames, cfg, with_cam=True, n_scans=n_scans, n_azimuth=n_azimuth,
        workers=workers, first=n_pairs + 1)
    scene, poses = eval_frames.synthetic_world(n_frames)
    cams = [T @ calib.imu_T_cam0 for T in poses[:n_pairs + 1]]
    return Drive(frames, cams, calib, scene, device)


def matches(drive: Drive, k: int, vo, nms: bool = False):
    """prev_uv, curr_uv [M, 2] and valid [M] of pair k: LK flow where the
    configuration asks for it, else detect / describe / match (with bucket
    NMS when `nms`), as the script composes them."""
    img0, img1 = drive.image(k), drive.image(k + 1)
    xy0, sc0, m0 = features.detect_keypoints(img0, vo)
    xy1, sc1, m1 = features.detect_keypoints(img1, vo)
    if vo.optical_flow_match:
        xy1m, status = lk_flow(img0, img1, xy0, vo)
        return xy0, xy1m, m0 & status
    if nms:
        m0 = features.bucket_nms(xy0, sc0, m0, vo.img_width, vo.img_height,
                                 vo.nms_bucket, vo.nms_bucket,
                                 vo.nms_max_total)
        m1 = features.bucket_nms(xy1, sc1, m1, vo.img_width, vo.img_height,
                                 vo.nms_bucket, vo.nms_bucket,
                                 vo.nms_max_total)
    d0 = features.describe_keypoints(img0, xy0, vo)
    d1 = features.describe_keypoints(img1, xy1, vo)
    idx1, ok = features.match_descriptors(d0, m0, d1, m1, vo.match_ratio,
                                          matcher=vo.matcher,
                                          select=vo.match_select)
    return xy0, xy1[idx1], ok


def solve(drive: Drive, prev_uv, curr_uv, valid, grid, vo):
    """solve_vo from rest; returns (angles [3], t [3], n32, n22) on the
    host."""
    z = torch.zeros(3, device=drive.device)
    a, t, n32, n22 = solve_vo(prev_uv, curr_uv, valid, grid, drive.Kinv, z,
                              z.clone(), vo)
    return (a.cpu().numpy().astype(np.float64),
            t.cpu().numpy().astype(np.float64), int(n32), int(n22))


def error(T_gt: np.ndarray, angles: np.ndarray, t: np.ndarray):
    """(rotation error mrad, translation error vector mm) of the estimate
    against the true motion."""
    T_est = np.eye(4)
    T_est[:3, :3] = R.from_rotvec(angles).as_matrix()
    T_est[:3, 3] = t
    dT = np.linalg.inv(T_gt) @ T_est
    return R.from_matrix(dT[:3, :3]).magnitude() * 1e3, dT[:3, 3] * 1e3


def match_quality(drive: Drive, k: int, prev_uv, curr_uv, valid, grid, vo):
    """The script's match quality: each valid match's previous pixel at its
    queried depth, moved by the true motion, against the current pixel.
    Returns (reprojection median px, share under 2 px) over the matches
    with depth."""
    pv = np.trunc(prev_uv.cpu().numpy().astype(np.float64))
    cv = np.trunc(curr_uv.cpu().numpy().astype(np.float64))
    dep = query_depth(grid, torch.trunc(prev_uv), vo).cpu().numpy()
    hd = valid.cpu().numpy() & (dep > 0)
    T_gt = drive.truth(k)
    bear = np.linalg.solve(drive.K, np.concatenate(
        [pv, np.ones((len(pv), 1))], 1).T).T
    X0 = bear * (dep / np.maximum(bear[:, 2], 1e-9))[:, None]
    X1 = (T_gt[:3, :3] @ X0.T).T + T_gt[:3, 3]
    uv1 = (drive.K @ X1.T).T
    uv1 = uv1[:, :2] / np.maximum(uv1[:, 2:], 1e-9)
    reproj = np.linalg.norm(uv1 - cv, axis=1)
    if not hd.any():
        return float("nan"), float("nan")
    return float(np.median(reproj[hd])), float((reproj[hd] < 2).mean())


def pair_stats(drive: Drive, k: int, vo, nms: bool = False, fam=None,
               quality: bool = False) -> dict:
    """Pair k under configuration vo: counts, errors (and, with quality,
    match_quality). fam: keep only the matches with depth ("32") or
    without ("22"), as family_ablation does."""
    prev_uv, curr_uv, valid = matches(drive, k, vo, nms)
    grid = drive.grid(k, vo)
    if fam is not None:
        has = query_depth(grid, torch.trunc(prev_uv), vo) > 0
        valid = valid & (has if fam == "32" else ~has)
    rec = {"valid": int(valid.sum())}
    if quality:
        rec["reproj_med"], rec["inlier2"] = match_quality(
            drive, k, prev_uv, curr_uv, valid, grid, vo)
    a, t, rec["n32"], rec["n22"] = solve(drive, prev_uv, curr_uv, valid,
                                         grid, vo)
    rec["rot_mrad"], e = error(drive.truth(k), a, t)
    rec["err_mm"] = [float(v) for v in e]
    rec["trans_mm"] = float(np.linalg.norm(e))
    return rec


def _means(recs: list[dict]) -> dict:
    keys = [k for k in recs[0] if k != "err_mm"]
    out = {k: float(np.nanmean([r[k] for r in recs])) for k in keys}
    out["err_mm"] = np.mean([r["err_mm"] for r in recs], 0).tolist()
    return out


def _variant_line(name: str, m: dict, width: int) -> str:
    return (f"{name:{width}s} err(x,y,z)mm "
            f"{np.round(m['err_mm'], 1).tolist()}  |t| {m['trans_mm']:4.0f} "
            f"mm  rot {m['rot_mrad']:5.2f} mrad  n32 {m['n32']:5.0f}  n22 "
            f"{m['n22']:5.0f}")


def main_entry(drive: Drive, vo) -> dict:
    """The script's main over base and lk-flow."""
    out = {}
    for label, v in (("base(zncc,bf,knn)", vo),
                     ("lk-flow", dataclasses.replace(
                         vo, optical_flow_match=True))):
        recs = [pair_stats(drive, k, v, quality=True)
                for k in range(drive.n_pairs)]
        m = _means(recs)
        print(f"\n== {label} ==\n  valid matches: {m['valid']:.0f}   n32: "
              f"{m['n32']:.0f}   n22: {m['n22']:.0f}\n  match reproj med: "
              f"{m['reproj_med']:.2f} px   inlier<2px: {m['inlier2']:.2f}\n"
              f"  f2f err: rot {m['rot_mrad']:.2f} mrad   trans "
              f"{m['trans_mm']:.0f} mm (x, y, z "
              f"{np.round(m['err_mm'], 1).tolist()})  (gt step 1200 mm)\n"
              "  per-frame trans err mm: "
              f"{[round(r['trans_mm']) for r in recs]}", flush=True)
        out[label] = {"mean": m, "pairs": recs}
    return out


def _table(drive: Drive, vo, variants: dict) -> dict:
    out = {}
    width = max(len(n) for n in variants) + 2
    for name, spec in variants.items():
        kw, fam = spec if isinstance(spec, tuple) else (spec, None)
        v = dataclasses.replace(vo, **kw)
        recs = [pair_stats(drive, k, v, nms=v.keypoint_nms, fam=fam)
                for k in range(drive.n_pairs)]
        m = _means(recs)
        print(_variant_line(name, m, width), flush=True)
        out[name] = {"mean": m, "pairs": recs}
    return out


def ablate(drive: Drive, vo) -> dict:
    return _table(drive, vo, ABLATE)


def family_ablation(drive: Drive, vo) -> dict:
    return _table(drive, vo, FAMILY)


def improve_ablation(drive: Drive, vo) -> dict:
    return _table(drive, vo, IMPROVE)


def improve_ablation2(drive: Drive, vo, variants=None) -> dict:
    return _table(drive, vo, variants or IMPROVE2)


def gt_depth_grid(drive: Drive, k: int, grid: DepthGrid) -> DepthGrid:
    """The grid with each live cell's depth replaced by the true depth
    along the ray through its centre (data/synthetic.py's raycast)."""
    from ..data import synthetic

    u = grid.u.cpu().numpy().astype(np.float64).ravel()
    v = grid.v.cpu().numpy().astype(np.float64).ravel()
    live = grid.cnt.cpu().numpy().ravel() > 0
    bear = np.linalg.solve(drive.K, np.stack([u, v, np.ones_like(u)])).T
    bear /= np.linalg.norm(bear, axis=1, keepdims=True)
    T = drive.cam_poses[k]
    dirs = bear @ T[:3, :3].T
    org = np.broadcast_to(T[:3, 3], dirs.shape)
    rng = synthetic._ray_scene_range(org, dirs, drive.scene)
    zt = np.where(np.isfinite(rng), rng * bear[:, 2], 0.0)
    z = np.where(live & (zt > 0), zt, 0.0).astype(np.float32)
    return grid._replace(z=drive.t(z.reshape(tuple(grid.z.shape))))


def error_anatomy(drive: Drive, vo) -> dict:
    """The translation error's components with the LiDAR grid and with the
    ground-truth-depth grid."""
    errs, errs_gt = [], []
    for k in range(drive.n_pairs):
        prev_uv, curr_uv, valid = matches(drive, k, vo)
        grid = drive.grid(k, vo)
        for g, acc in ((grid, errs), (gt_depth_grid(drive, k, grid),
                                      errs_gt)):
            a, t, _, _ = solve(drive, prev_uv, curr_uv, valid, g, vo)
            acc.append(error(drive.truth(k), a, t)[1])
    out = {}
    for name, e in (("lidar depth", np.asarray(errs)),
                    ("gt-ray depth", np.asarray(errs_gt))):
        mean = np.linalg.norm(e, axis=1).mean()
        print(f"{name}: mean err vec (x,y,z mm) = "
              f"{np.round(e.mean(0), 1).tolist()}  |e| mean {mean:.0f} mm",
              flush=True)
        out[name] = {"err_mm": e.mean(0).tolist(), "trans_mm": float(mean),
                     "pairs": e.tolist()}
    return out


RUNS = {"main": main_entry, "ablate": ablate,
        "error_anatomy": error_anatomy, "family_ablation": family_ablation,
        "improve_ablation": improve_ablation,
        "improve_ablation2": improve_ablation2}
PAIRS = {"main": 10}  # the script's defaults; the others take 8


def main(argv=None) -> int:
    from ..config import kitti_hdl64
    from ..lidar.loam_step import engine_device

    ap = argparse.ArgumentParser(prog="diag_vo",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--entry", default="main", choices=ENTRIES + ("all",))
    ap.add_argument("--pairs", type=int, default=None,
                    help="frame pairs (default: the script's, 10 for main, "
                    "8 for the others)")
    args = ap.parse_args(argv)
    dev = engine_device(args.device)
    vo = kitti_hdl64().replace(detach_VO_LO=False).vo
    entries = ENTRIES if args.entry == "all" else (args.entry,)
    pairs = {e: args.pairs or PAIRS.get(e, 8) for e in entries}
    t0 = time.perf_counter()
    drive = load_drive(max(pairs.values()), kitti_hdl64(), dev)
    for e in entries:
        t1 = time.perf_counter()
        n = pairs[e]
        print(f"\n#### {e} ({n} pairs of the {DRIVE_FRAMES}-frame drive, "
              f"{dev})", flush=True)
        rec = RUNS[e](drive.head(n), vo)
        print(json.dumps({"tool": "diag_vo", "entry": e, "pairs": n,
                          "device": str(dev), "result": rec,
                          "seconds": time.perf_counter() - t1}), flush=True)
    print(f"\n{time.perf_counter() - t0:.0f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
