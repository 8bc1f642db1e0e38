"""The distributed mapping solve at several mesh sizes against the
single-device solve (port of scripts/bench_mesh.py).

    python -m vloam_tpu_torch.tools.bench_mesh [--device cpu]
        [--sizes 1,2,4] [--reps 3]

One real frame, built as the script builds it (tests/test_mesh_pipeline.py's
lean shapes, kept here as mesh_cfg, scan_frames and run_single_device): the
voxel-downsampled stacks of the 6th frame of scan_frames(cfg, 6, seed=11),
the map the single-device host stages (LaserOdometry + LaserMapping) leave
after frames 0-4, and the pose predicted from that map's odom offset and a
fresh LaserOdometry over all 6 frames. The frame goes through
lidar/mapping.py's single-device solve_mapping (the reference pose) and
through parallel/mesh_pipeline.py's mesh_solve_mapping at each mesh size D:

- D = 1 in this process (a one-rank group: gloo on the CPU, NCCL on the
  card);
- D > 1 as D ranks started by parallel/launch.py (this module's --rank
  entry point): gloo on the CPU, or on the card gloo ranks sharing it (the
  ring hop through host memory), as chip_smoke.py's M3.

For each D: the translation error against the single-device solve (mm),
each rank's accepted residual count (sharded_map_alignment's counts on the
same shards, taken in an untimed call) and the wall ms of one solve (mean
of --reps after a warm-up, a synchronize each). As the script notes, ranks
on one machine share its cores (or one card): what this checks is that the
pose does not move with D and that the work splits 1/D; the wall time is
not a scaling figure. The last line is JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from ..config import (LaserMappingConfig, LidarProfile, PipelineConfig,
                      ScanRegistrationConfig)
from ..data import synthetic

REPO = Path(__file__).resolve().parents[2]
N_FRAMES, SEED = 6, 11


def mesh_cfg() -> PipelineConfig:
    """tests/test_mesh_pipeline.py::mesh_cfg: lean shapes, as the flat-map
    ring k-NN is O(stacks x map slots) a hop."""
    return PipelineConfig(
        lidar=LidarProfile(name="m32", n_scans=32, minimum_range=2.0,
                           max_points=32768, ring_capacity=1024),
        scanreg=ScanRegistrationConfig(sharp_cap=512, less_sharp_cap=4096,
                                       flat_cap=1024, less_flat_cap=8192),
        mapping=LaserMappingConfig(cube_width=11, cube_height=11,
                                   cube_depth=5, map_n_buckets=1 << 12,
                                   corner_bucket_cap=8, surf_bucket_cap=8,
                                   corner_stack_cap=1024,
                                   surf_stack_cap=2048))


def scan_frames(cfg, n_frames: int, seed: int = 7) -> list[np.ndarray]:
    """tests/test_mesh_pipeline.py::_scan_frames."""
    scene = synthetic.urban_scene(seed)
    poses = synthetic.drive_trajectory(n_frames, speed=1.2, yaw_rate=0.02)
    return [synthetic.simulate_scan(scene, T, n_scans=cfg.lidar.n_scans,
                                    n_azimuth=600, seed=seed * 100 + k)
            for k, T in enumerate(poses)]


def _features(cfg, pts, device):
    from ..lidar.scan_registration import register_scan

    padded, n = synthetic.pad_scan(pts, cfg.lidar.max_points)
    return register_scan(torch.from_numpy(padded).to(device), n, cfg.lidar,
                         cfg.scanreg)


def run_single_device(cfg, scans, device):
    """tests/test_mesh_pipeline.py::_run_single_device: the host stages
    (LaserOdometry + LaserMapping) over `scans`. Returns (t_mo [N, 3], the
    LaserMapping)."""
    from ..lidar.mapping import LaserMapping
    from ..lidar.odometry import LaserOdometry

    lo = LaserOdometry(cfg.lo, device=device)
    mo = LaserMapping(cfg.mapping, device=device)
    t_mo = []
    for pts in scans:
        feats = _features(cfg, pts, device)
        lo_out = lo.step(feats)
        mo_out = mo.step(feats.less_sharp, feats.less_flat, lo_out["q_w"],
                         lo_out["t_w"], skip_frame=lo_out["skip_frame"])
        t_mo.append(np.asarray(mo_out["t_w"]))
    return np.stack(t_mo), mo


def build_frame(cfg, device) -> dict:
    """The script's frame: {map (GridMap), c_xyz, c_m, s_xyz, s_m, q_pred,
    t_pred} on `device`."""
    from ..lidar.odometry import LaserOdometry
    from ..lidar.voxel import voxel_downsample

    scans = scan_frames(cfg, N_FRAMES, seed=SEED)
    _, mo = run_single_device(cfg, scans[:-1], device)
    lo = LaserOdometry(cfg.lo, device=device)
    for pts in scans:
        feats = _features(cfg, pts, device)
        lo_out = lo.step(feats)
    r_off = Rotation.from_quat(mo.q_wmap_wodom)
    q_pred = (r_off * Rotation.from_quat(np.asarray(lo_out["q_w"]))).as_quat()
    t_pred = mo.t_wmap_wodom + r_off.apply(np.asarray(lo_out["t_w"]))
    m = cfg.mapping
    c_xyz, _, _, c_m = voxel_downsample(
        feats.less_sharp.xyz, feats.less_sharp.mask, m.line_resolution,
        m.corner_stack_cap)
    s_xyz, _, _, s_m = voxel_downsample(
        feats.less_flat.xyz, feats.less_flat.mask, m.plane_resolution,
        m.surf_stack_cap)
    return {"map": mo.map, "c_xyz": c_xyz, "c_m": c_m, "s_xyz": s_xyz,
            "s_m": s_m,
            "q_pred": torch.tensor(q_pred, dtype=torch.float32,
                                   device=device),
            "t_pred": torch.tensor(t_pred, dtype=torch.float32,
                                   device=device)}


def single_solve(frame, cfg):
    """lidar/mapping.py's solve_mapping on the frame: (q, t) on the host."""
    from ..lidar.mapping import solve_mapping

    _, q, t, _ = solve_mapping(frame["map"], frame["c_xyz"], frame["c_m"],
                               frame["s_xyz"], frame["s_m"],
                               frame["q_pred"], frame["t_pred"], cfg.mapping)
    return q.cpu().numpy(), t.cpu().numpy()


def _args(frame):
    return (frame["map"], frame["c_xyz"], frame["c_m"], frame["s_xyz"],
            frame["s_m"], frame["q_pred"], frame["t_pred"])


def mesh_solve(mesh, frame, cfg, reps: int) -> dict:
    """mesh_solve_mapping on this rank: the pose, the wall ms of a solve
    and every rank's accepted count [D] (every rank calls it)."""
    from ..lidar.gridmap import grid_flat_points
    from ..parallel.mesh_pipeline import mesh_solve_mapping
    from ..parallel.sharded import shard_batch
    from ..parallel.sharded_mapping import sharded_map_alignment

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    mesh_solve_mapping(mesh, *_args(frame), cfg.mapping)  # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        _, q, t, _ = mesh_solve_mapping(mesh, *_args(frame), cfg.mapping)
        sync()
    ms = (time.perf_counter() - t0) / reps * 1e3
    gm = frame["map"]
    mc, mc_m = grid_flat_points(gm.corner)
    ms_, ms_m = grid_flat_points(gm.surf)
    x0 = torch.cat([frame["q_pred"], frame["t_pred"]])
    _, counts = sharded_map_alignment(
        mesh, *(shard_batch(a, mesh) for a in (
            frame["c_xyz"], frame["c_m"], frame["s_xyz"], frame["s_m"], mc,
            mc_m, ms_, ms_m)), x0, cfg.mapping, return_counts=True)
    return {"q": q.cpu().numpy(), "t": t.cpu().numpy(), "ms": ms,
            "counts": counts.cpu().numpy().astype(np.int64)}


def _save_frame(frame, path) -> None:
    gm = frame["map"]
    arrs = {"corner": gm.corner.pts, "corner_n": gm.corner.n_live,
            "surf": gm.surf.pts, "surf_n": gm.surf.n_live,
            "center": gm.center,
            **{k: frame[k] for k in ("c_xyz", "c_m", "s_xyz", "s_m",
                                     "q_pred", "t_pred")}}
    np.savez(path, **{k: v.cpu().numpy() for k, v in arrs.items()})


def _load_frame(path, device) -> dict:
    from ..lidar.gridmap import FeatureGrid
    from ..lidar.mapping import GridMap

    z = {k: torch.from_numpy(v).to(device) for k, v in np.load(path).items()}
    gm = GridMap(FeatureGrid(z["corner"], z["corner_n"]),
                 FeatureGrid(z["surf"], z["surf_n"]), z["center"])
    return {"map": gm, **{k: z[k] for k in ("c_xyz", "c_m", "s_xyz", "s_m",
                                            "q_pred", "t_pred")}}


def rank_main(inp: str, out: str, device: str, backend: str,
              reps: int) -> None:
    """One rank of a D > 1 run (started by parallel/launch.py)."""
    from ..parallel.sharded import spmd_mesh

    torch.set_num_threads(max(1, int(os.environ.get("OMP_NUM_THREADS",
                                                    "1"))))
    with spmd_mesh(device=device, backend=backend) as mesh:
        frame = _load_frame(inp, mesh.device)
        res = mesh_solve(mesh, frame, mesh_cfg(), reps)
        if mesh.rank == 0:
            np.savez(out, **res, device=str(mesh.device))


def _rank_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def run(device="cuda", sizes=(1, 2, 4), reps: int = 3,
        timeout: float = 600) -> dict:
    """Every mesh size; returns the JSON record (rows a size)."""
    from ..lidar.loam_step import engine_device
    from ..parallel.launch import launch
    from ..parallel.sharded import spmd_mesh

    dev = engine_device(device)
    cfg = mesh_cfg()
    t0 = time.perf_counter()
    frame = build_frame(cfg, dev)
    q_ref, t_ref = single_solve(frame, cfg)
    print(f"[bench_mesh] single-device solve_mapping pose t = {t_ref} "
          f"(frame built in {time.perf_counter() - t0:.1f} s on {dev})",
          flush=True)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "frame.npz")
        _save_frame(frame, inp)
        for D in sizes:
            t1 = time.perf_counter()
            if D == 1:
                backend = "nccl" if dev.type == "cuda" else "gloo"
                with spmd_mesh(device=dev.type) as mesh:
                    res = mesh_solve(mesh, frame, cfg, reps)
                how = f"1 {backend} rank in this process"
            else:
                out = os.path.join(tmp, f"out{D}.npz")
                run_ = launch(["-m", "vloam_tpu_torch.tools.bench_mesh",
                               "--rank", inp, out, "--device", dev.type,
                               "--backend", "gloo", "--reps", str(reps)],
                              D, timeout=timeout, env=_rank_env())
                if run_.code != 0:
                    raise RuntimeError(f"{D} ranks exited {run_.code}\n"
                                       + run_.report())
                res = dict(np.load(out))
                how = (f"{D} gloo ranks" + (" sharing the card"
                                            if dev.type == "cuda" else ""))
            err = float(np.linalg.norm(res["t"].astype(np.float64)
                                       - t_ref)) * 1e3
            rot = float((Rotation.from_quat(res["q"]).inv()
                         * Rotation.from_quat(q_ref)).magnitude())
            row = {"D": D, "how": how, "t_err_mm": err, "rot_err_rad": rot,
                   "accepted": [int(c) for c in res["counts"]],
                   "solve_ms": float(res["ms"]),
                   "seconds": time.perf_counter() - t1,
                   "t": [float(v) for v in res["t"]]}
            rows.append(row)
            print(f"mesh D={D} ({how}): solve {row['solve_ms']:8.1f} ms  "
                  f"|t - t_single| = {err:.3f} mm, rotation "
                  f"{rot:.2e} rad; accepted by rank {row['accepted']}",
                  flush=True)
    return {"tool": "bench_mesh", "device": str(dev),
            "t_single": [float(v) for v in t_ref], "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_mesh",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default="1,2,4",
                    help="mesh sizes, comma-separated (default 1,2,4)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rank", nargs=2, metavar=("IN", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--backend", default="gloo", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank:
        rank_main(*args.rank, args.device, args.backend, args.reps)
        return 0
    rec = run(args.device, [int(s) for s in args.sizes.split(",")],
              args.reps)
    print("note: the ranks share one machine's cores (or one card), so the "
          "wall time does not fall with D; what this checks is the pose "
          "(equal to the single-device solve at every D) and the work's 1/D "
          "split", flush=True)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
