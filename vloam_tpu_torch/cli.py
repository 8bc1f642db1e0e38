"""Command line of the PyTorch engines (port of vloam_tpu/cli.py).

Sequences are driven from KITTI files (or the built-in synthetic world)
through the fused engines (--engine fused, the default) or the per-stage
host engine (--engine host: per-frame progress, a per-stage timing summary,
--viz debug PNGs), trajectories are written in the reference's
results/<run>/{VO,LO,MO}{0,1}.txt layout, and progress goes to stdout.
--optical-flow matches by LK flow in either engine. Everything runs on the
card unless --device cpu is given.

--mesh N runs the mapping stage as distributed BA over N ranks
(parallel/): N processes started by parallel/launch.py, NCCL with one rank
a card under --device cuda (N visible cards needed), gloo under --device
cpu; one rank runs in this process. Rank 0 writes the files and prints.

Usage:
  python -m vloam_tpu_torch run --synthetic 20 --out results/synth
  python -m vloam_tpu_torch run --odometry-root /data/kitti --seq 00 \\
      --mode combined
  python -m vloam_tpu_torch run --raw-root /data/kitti_raw \\
      --date 2011_09_26 --drive 0001 --device cpu
  python -m vloam_tpu_torch run --synthetic 12 --mode combined \\
      --engine host --viz results/viz --optical-flow
  python -m vloam_tpu_torch run --synthetic 12 --device cpu --mesh 2
  python -m vloam_tpu_torch eval --gt gt.txt --pred results/synth/MO1.txt
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np


def _add_run(sub):
    p = sub.add_parser("run", help="run the VLOAM pipeline on a sequence")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="run N synthetic frames instead of a dataset")
    p.add_argument("--odometry-root", help="KITTI odometry dataset root")
    p.add_argument("--seq", default="00")
    p.add_argument("--raw-root", help="KITTI raw dataset root")
    p.add_argument("--date", default="2011_09_26")
    p.add_argument("--drive", default="0001")
    p.add_argument("--start-frame", type=int, default=0)
    p.add_argument("--end-frame", type=int, default=-1)
    p.add_argument("--mode", choices=["combined", "detached", "lidar-only"],
                   default="detached")
    p.add_argument("--sensor", choices=["hdl64", "hdl32", "vlp16", "tiny"],
                   default="hdl64",
                   help="lidar sensor profile (reference launch variants "
                        "loam_velodyne_{HDL_64,HDL_32,VLP_16}.launch; tiny = "
                        "small-shape test profile for CI fixtures)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the hand-written kernels on the "
                        "card; cpu: their plain PyTorch versions")
    p.add_argument("--engine", choices=["fused", "host"], default="fused",
                   help="fused: device-resident chunks, one download per "
                        "sequence; host: the per-stage classes, one host "
                        "read per stage and frame (debuggable, timed per "
                        "stage)")
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--polar-ingest", action="store_true",
                   help="native bin->range-image projection + uint16 upload "
                        "(smallest host->device bytes)")
    p.add_argument("--out", default=None, help="output directory for txt files")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace (trace.json) "
                        "into this directory")
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--viz", default=None, metavar="DIR",
                   help="debug PNGs (matches or flow arrows, and depth) "
                        "every 10 frames (host engine only)")
    p.add_argument("--optical-flow", action="store_true",
                   help="match keypoints by pyramidal LK optical flow "
                        "instead of descriptors")
    p.add_argument("--init-state", default=None, metavar="NPZ",
                   help="restore full device state (map + pose chain) from "
                        "a checkpoint before the run (either package's; "
                        "fused engine only, the host engine ignores it)")
    p.add_argument("--save-state", default=None, metavar="NPZ",
                   help="save full device state after the run (resume long "
                        "drives / reuse maps in later runs; fused engine "
                        "only, the host engine ignores it)")
    p.add_argument("--save-map", default=None, metavar="DIR",
                   help="export the accumulated map every map_pub_number "
                        "frames as npz under DIR (reference /laser_cloud_map "
                        "publisher analogue; fused engine only, the host "
                        "engine ignores it)")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="run the mapping stage as distributed BA over N "
                        "ranks (sharded scan stacks + map blocks, windowed "
                        "ring k-NN, all-reduced normal equations): with "
                        "--engine fused the mesh mapping chunk inside the "
                        "engines, with --engine host MeshLaserMapping. "
                        "NCCL, one rank a card, under --device cuda; gloo "
                        "ranks under --device cpu")
    p.add_argument("--reference-exact", action="store_true",
                   help="roll every accuracy-motivated default divergence "
                        "back to the reference's values "
                        "(config.reference_exact) for parity runs")
    p.add_argument("--compare-ref", default=None, metavar="DIR",
                   help="after the run, compare each produced "
                        "{VO,LO,MO}{suffix}.txt stream against the "
                        "same-named file in DIR and print ATE/RPE per "
                        "stream (the one-command KITTI parity harness)")
    p.add_argument("--loop-close", action="store_true",
                   help="after the sequence, detect loop closures (scan "
                        "re-matching) and re-optimize the MO trajectory "
                        "with the pose-graph backend; writes MO<d>_loop.txt")
    p.add_argument("--loop-radius", type=float, default=10.0)
    p.add_argument("--loop-min-gap", type=int, default=50)


def _add_eval(sub):
    p = sub.add_parser("eval", help="KITTI metrics between two pose files")
    p.add_argument("--gt", required=True)
    p.add_argument("--pred", required=True)


def _refuse_unsupported(ap, args) -> None:
    if args.polar_ingest and args.engine == "host":
        ap.error("--polar-ingest feeds range images, which only the fused "
                 "engine reads; the host engine reads xyz points (drop "
                 "--polar-ingest or use --engine fused)")


def _fit_cfg_to_images(cfg, ds, start_frame, mode):
    """Size the vision path to the dataset's native image size (KITTI sizes
    vary per sequence: 1241x376, 1226x370, 1242x375, ...). Keeps the config
    default when no images exist."""
    if mode == "lidar-only" or not getattr(ds, "img_files", None):
        return cfg
    import dataclasses

    from .data.kitti import load_image_gray

    h, w = load_image_gray(ds.img_files[min(start_frame,
                                            len(ds.img_files) - 1)]).shape
    if (h, w) == (cfg.vo.img_height, cfg.vo.img_width):
        return cfg
    return cfg.replace(vo=dataclasses.replace(cfg.vo, img_height=h,
                                              img_width=w))


def _dataset_get_points(ds, start_frame, cfg):
    """Scan-by-index accessor for the loop-closure backend."""
    from .data.kitti import load_velodyne_bin
    from .data.synthetic import pad_scan

    def get_points(k):
        pts = load_velodyne_bin(ds.velo_files[start_frame + k])
        return pad_scan(pts, cfg.lidar.max_points)

    return get_points


def _run_loop_closure(result, calib, cfg, get_points, args, mesh=None):
    """Post-sequence loop closure + pose-graph re-optimization of the MO
    trajectory (the reference drifts without bound)."""
    from scipy.spatial.transform import Rotation as Rot

    from .backend.loop_closure import close_loops
    from .fusion.frame_chain import FrameChain, write_kitti_pose_line
    from .geometry.np_pose import inv_T, qt_to_T

    chain = FrameChain(np.asarray(calib.imu_T_velo, np.float64),
                       np.asarray(calib.imu_T_cam0, np.float64))
    B = chain.base_T_cam0
    Binv = np.linalg.inv(B)
    mo = np.asarray(result["MO"], np.float64)  # [N, 3, 4] cam0-start
    bottom = np.broadcast_to(np.asarray([[0.0, 0, 0, 1]]), (len(mo), 1, 4))
    X = np.concatenate([mo, bottom], axis=1)
    W = np.einsum("ij,njk,kl->nil", B, X, Binv)  # world_T_base per frame
    q_w = Rot.from_matrix(W[:, :3, :3]).as_quat()
    t_w = W[:, :3, 3]

    res = close_loops(q_w, t_w, get_points, cfg, radius=args.loop_radius,
                      min_gap=args.loop_min_gap, mesh=mesh,
                      device=args.device)
    print(f"loop closure: {len(res['loops'])} loop(s) accepted "
          f"{res['loops']}")
    opt = np.asarray(res["poses"], np.float64)
    Wo = qt_to_T(opt[:, :4], opt[:, 4:])
    Xo = np.einsum("ij,njk,kl->nil", Binv, Wo, B)
    traj = np.einsum("ij,njk->nik", inv_T(Xo[0]), Xo)[:, :3, :]
    result["MO_loop"] = traj
    if args.out is not None:
        suffix = str(int(cfg.detach_VO_LO))
        with open(Path(args.out) / f"MO{suffix}_loop.txt", "w") as f:
            for T34 in traj:
                write_kitti_pose_line(f, T34)


def _compare_against_reference(result, cfg, ref_dir):
    """Per-stream ATE/RPE of this run's trajectories vs a reference results
    directory holding {VO,LO,MO}{0,1}.txt files (reference layout:
    src/vloam_main/results/<date>_drive_<seq>/, pose format
    vloam_tf.cpp:93-99). Streams whose file is absent are skipped. Returns
    {stream: metrics-dict} and prints one JSON line per stream."""
    from .eval.kitti_metrics import kitti_metrics, load_kitti_poses

    suffix = str(int(cfg.detach_VO_LO))
    report = {}
    for which in ("VO", "LO", "MO"):
        if which not in result or not len(result[which]):
            continue
        ref_file = Path(ref_dir) / f"{which}{suffix}.txt"
        if not ref_file.exists():
            print(f"compare-ref: {ref_file.name} not present in {ref_dir}, "
                  "skipped")
            continue
        ref = load_kitti_poses(ref_file)
        pred = np.asarray(result[which], np.float64)
        n = min(len(ref), len(pred))
        if n < 2:
            continue
        m = kitti_metrics(ref[:n], pred[:n], step=1)
        m["n_frames"] = int(n)
        report[which] = m
        print(f"compare-ref {which}{suffix}: {json.dumps(m)}")
    return report


def _synthetic_setup(n, cfg, mode):
    """The built-in synthetic drive: (calib, frames, get_points, ground
    truth in the cam0 start frame)."""
    from types import SimpleNamespace

    from .data import synthetic

    scene = synthetic.urban_scene(0)
    K, P_rect0, _, velo_T_cam = synthetic.default_cam_calib(
        cfg.vo.img_width, cfg.vo.img_height)
    calib = SimpleNamespace(
        K=K, P_rect0=P_rect0, P_velo_to_img=P_rect0 @ np.linalg.inv(
            velo_T_cam), imu_T_velo=np.eye(4), imu_T_cam0=velo_T_cam)
    poses = synthetic.drive_trajectory(n, speed=1.1, yaw_rate=0.01)
    use_cam = mode != "lidar-only"

    def scan(k):
        return synthetic.simulate_scan(scene, poses[k],
                                       n_scans=cfg.lidar.n_scans,
                                       n_azimuth=1800, seed=k)

    def frames():
        for k, T in enumerate(poses):
            f = {"points": scan(k)}
            if use_cam:
                f["image"] = synthetic.render_camera(
                    scene, T @ velo_T_cam, K, cfg.vo.img_width,
                    cfg.vo.img_height)
            yield f

    def get_points(k):
        return synthetic.pad_scan(scan(k), cfg.lidar.max_points)

    T0 = poses[0] @ velo_T_cam
    gt = np.stack([(np.linalg.inv(T0) @ (T @ velo_T_cam))[:3, :]
                   for T in poses])
    return calib, frames(), get_points, gt


def _launch_ranks(n: int, argv: list[str]) -> int:
    """Run this command line as n ranks (parallel/launch.py) and return the
    first nonzero exit code, or 0; a failure names each rank's exit code and
    the end of its stderr."""
    from .parallel.launch import launch

    env = dict(os.environ)
    root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    run = launch(["-m", "vloam_tpu_torch", *argv], n, env=env)
    if run.code:
        print(f"--mesh {n}: the ranks exited {run.code}\n{run.report()}",
              file=sys.stderr, flush=True)
    return run.code


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vloam_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_run(sub)
    _add_eval(sub)
    args = ap.parse_args(argv)

    if args.cmd == "eval":
        from .eval.kitti_metrics import kitti_metrics, load_kitti_poses

        m = kitti_metrics(load_kitti_poses(args.gt), load_kitti_poses(args.pred))
        print(json.dumps(m, indent=2))
        return 0

    # cmd == run
    _refuse_unsupported(ap, args)
    import torch

    if args.mesh:
        if args.init_state or args.save_state:
            ap.error("--mesh shards the map, which checkpoints do not hold "
                     "(as in the reference); drop --init-state / "
                     "--save-state")
        if args.device == "cuda" and torch.cuda.device_count() < args.mesh:
            ap.error(f"--mesh {args.mesh} under --device cuda needs "
                     f"{args.mesh} visible cards (one NCCL rank a card); "
                     f"{torch.cuda.device_count()} visible")
        if args.mesh > 1 and "RANK" not in os.environ:
            return _launch_ranks(args.mesh, sys.argv[1:] if argv is None
                                 else argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda (the default) needs a GPU and "
                 "torch.cuda.is_available() is false; pass --device cpu to "
                 "run the plain PyTorch versions on the CPU")
    from .config import (HDL32, VLP16, PipelineConfig, kitti_hdl64,
                         reference_exact, tiny_test_profile)

    if args.reference_exact:
        if args.sensor != "hdl64":
            ap.error("--reference-exact is the HDL-64 KITTI parity profile")
        cfg = reference_exact()
    else:
        cfg = {
            "hdl64": kitti_hdl64,
            "hdl32": lambda: PipelineConfig(lidar=HDL32),
            "vlp16": lambda: PipelineConfig(lidar=VLP16),
            "tiny": tiny_test_profile,
        }[args.sensor]()
    cfg = cfg.replace(
        detach_VO_LO=(args.mode != "combined"), verbose_level=args.verbose
    )
    if args.optical_flow:
        import dataclasses

        cfg = cfg.replace(vo=dataclasses.replace(cfg.vo,
                                                 optical_flow_match=True))

    gt_poses = None
    if args.synthetic:
        calib, frame_iter, get_points, gt_poses = _synthetic_setup(
            args.synthetic, cfg, args.mode)
    elif args.odometry_root or args.raw_root:
        from .data.kitti import KittiOdometrySequence, KittiRawDrive
        from .runtime import native_io

        if args.odometry_root:
            ds = KittiOdometrySequence(args.odometry_root, args.seq,
                                       polar_ingest=args.polar_ingest,
                                       polar_scans=cfg.lidar.n_scans)
        else:
            ds = KittiRawDrive(args.raw_root, args.date, args.drive,
                               polar_ingest=args.polar_ingest,
                               polar_scans=cfg.lidar.n_scans)
        if args.verbose:
            print("kitti io: "
                  + ("native (runtime/native/kitti_io.cpp)"
                     if native_io.available() else "numpy fallback")
                  + (", polar ingest" if args.polar_ingest else ""),
                  flush=True)
        calib = ds.calib
        end = len(ds) if args.end_frame < 0 else min(args.end_frame + 1, len(ds))
        frame_iter = (ds.frame(i) for i in range(args.start_frame, end))
        cfg = _fit_cfg_to_images(cfg, ds, args.start_frame, args.mode)
        get_points = _dataset_get_points(ds, args.start_frame, cfg)
    else:
        ap.error("one of --synthetic / --odometry-root / --raw-root required")

    if args.mode == "lidar-only":
        frame_iter = (
            {"polar": f["polar"]} if "polar" in f else {"points": f["points"]}
            for f in frame_iter
        )

    if not args.mesh:
        return _run(args, cfg, calib, frame_iter, get_points, gt_poses)
    from .parallel.sharded import spmd_mesh

    # every rank ends the group, on success and on error
    with spmd_mesh(device=args.device) as mesh:
        if mesh.size != args.mesh:
            ap.error(f"--mesh {args.mesh}, but the process group has "
                     f"{mesh.size} ranks")
        if mesh.rank != 0:  # rank 0 alone writes files
            args.out = None
        return _run(args, cfg, calib, frame_iter, get_points, gt_poses, mesh)


def _run(args, cfg, calib, frame_iter, get_points, gt_poses,
         mesh=None) -> int:
    """Drive the sequence, print the summaries and metrics; mesh: this
    rank's Mesh under --mesh."""
    from . import kernels
    from .pipeline import run_sequence, run_sequence_fused
    from .runtime.profiling import summarize_timings

    def progress(k, info):
        if args.verbose:
            print(f"frame {k}: {info['t_frame_ms']:.1f} ms "
                  f"(scanreg {info.get('t_scanreg_ms', 0):.1f}, "
                  f"lo {info.get('t_lo_ms', 0):.1f}, "
                  f"mo {info.get('t_mo_ms', 0):.1f})", flush=True)

    kernels.reset_launches()
    ctx = None
    if args.profile:
        from .runtime.profiling import device_trace

        ctx = device_trace(args.profile)
        ctx.__enter__()
    try:
        if args.engine == "fused":
            result = run_sequence_fused(
                cfg, calib, frame_iter, out_dir=args.out, chunk=args.chunk,
                lidar_only=(args.mode == "lidar-only"), verbose=args.verbose,
                save_map=args.save_map, init_state=args.init_state,
                save_state_path=args.save_state, mesh=mesh,
                device=args.device)
        else:
            result = run_sequence(cfg, calib, frame_iter, out_dir=args.out,
                                  progress=progress, viz_dir=args.viz,
                                  mesh=mesh, device=args.device)
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)

    if "timings" in result:
        print("timing summary (ms):",
              json.dumps(summarize_timings(result["timings"]), indent=2))
    if "fps" in result:
        print(f"throughput: {result['fps']:.1f} frames/s on {args.device}")
    if args.verbose and args.device == "cuda":
        print(f"kernel launches: {json.dumps(kernels.LAUNCHES)}")
    if args.loop_close and "MO" in result and len(result["MO"]) > 2:
        _run_loop_closure(result, calib, cfg, get_points, args, mesh)
    if args.compare_ref:
        _compare_against_reference(result, cfg, args.compare_ref)
    if gt_poses is not None:
        from .eval.kitti_metrics import kitti_metrics

        for which in ("VO", "LO", "MO", "MO_loop"):
            if which in result and len(result[which]):
                m = kitti_metrics(gt_poses, result[which], step=1)
                print(which, json.dumps(m))
    return 0


if __name__ == "__main__":
    sys.exit(main())
