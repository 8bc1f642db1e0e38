"""Drive the PyTorch port's main paths once on one NVIDIA GPU: the LiDAR-only
LOAM engine and the combined camera + LiDAR engine.

    python3 chip_smoke.py

Phases (one line each; any failure ends the run with a nonzero exit):
  1. device: the card's name and power limit; CUDA required, TF32 off
  2. build: compile the hand-written kernels from kernels/csrc with nvcc
  frames: a 48-frame synthetic HDL-64 polar drive (64 x 1800) and its
     1242 x 375 camera images, rendered in worker processes
  warm-up: ~3 s of matmuls so that the timed phases start on a busy card
  3. K1 select_rings vs its plain PyTorch version on real frame layouts
  4. K2 ring_min2 vs its plain version at the corner and surf LO shapes
  5. end to end: LoamEngine(kitti_hdl64(), chunk=16, device="cuda") over the
     drive; frames/s, kernel launch counts, MO error against ground truth,
     no host sync in the timed frames
  6. the first 6 frames again on the CPU (plain versions): trajectories agree
  7. K3 zncc_describe vs its plain version on keypoints of rendered frames
     plus crafted rows (image corners, a constant patch), p = 24 and 16
  8. end to end: VloamEngine(kitti_hdl64() with detach_VO_LO=False,
     chunk=16, device="cuda") over the drive and its images; frames/s, kernel
     launch counts, LO / MO error and VO ATE against ground truth, no host
     sync
  9. the first 4 frames of phase 8 again on the CPU: LO, MO and VO agree
  10. launches per frame: torch.profiler over 8 steady frames of each engine
Phases 3-5 and 7-8 end with the SM clock, its maximum, the power draw and
the temperature that nvidia-smi reads just after their timed runs. Then the
kernels' JSON line, the card's line and, last, the device line.

Imports nothing of JAX or of the JAX package: the configuration and the
synthetic scene generator are the port's own (vloam_tpu_torch.config,
vloam_tpu_torch.data.synthetic).
"""

from __future__ import annotations

import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

N_FRAMES = 48
CHUNK = 16
N_AZ = 1800
CPU_FRAMES = 6
IMG_W, IMG_H = 1242, 375
VLOAM_CPU_FRAMES = 4
PROFILE_FRAMES = 8
# card vs CPU bounds of the combined engine, in metres over the first
# VLOAM_CPU_FRAMES frames: LO and MO as phase 6 (the golden tolerances);
# VO as MO (the depth grid adds by atomics on the card, and the VO LM sums
# in another order)
VLOAM_CPU_TOL = {"LO": 2e-2, "MO": 3e-2, "VO": 3e-2}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def clocks() -> str:
    """The card's SM clock / max SM clock, power draw and temperature."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True)
    sm, sm_max, power, temp = smi.stdout.strip().splitlines()[0].split(", ")
    return f"[SM {sm} of {sm_max}, {power}, {temp} C]"


def warm_up(seconds: float = 3.0) -> None:
    """Keep the card busy for `seconds` (f32 matmuls) before timing."""
    a = torch.randn((4096, 4096), device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            b = a @ a
        torch.cuda.synchronize()
    del a, b
    print(f"[warm-up] {seconds:.0f} s of 4096^2 matmuls {clocks()}",
          flush=True)


def cuda_ms(fn, runs: int = 25) -> float:
    """Median device time of fn() in ms, from CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_phase() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    # float32 products in full precision (the LM normal equations are
    # einsums over ~10k rows); tolerances below assume it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, TF32 off", flush=True)
    return card


def build_phase() -> None:
    from vloam_tpu_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    print(f"[2 build] {lib.name} in {time.perf_counter() - t0:.2f} s",
          flush=True)


class Calib:
    """The synthetic rig's calibration: the camera sits at the velodyne
    origin (vloam_tpu_torch.data.synthetic.default_cam_calib)."""

    def __init__(self):
        from vloam_tpu_torch.data import synthetic

        self.K, P_rect0, _, velo_T_cam = synthetic.default_cam_calib(IMG_W,
                                                                     IMG_H)
        self.P_velo_to_img = P_rect0 @ np.linalg.inv(velo_T_cam)
        self.imu_T_velo = np.eye(4)
        self.imu_T_cam0 = velo_T_cam


def _render(k: int, T: np.ndarray):
    """Frame k: the polar scan and the camera image from sensor pose T."""
    from vloam_tpu_torch.data import synthetic

    scene = synthetic.urban_scene(0, extent=80.0)
    calib = Calib()
    scan = synthetic.simulate_scan_polar(scene, T, n_scans=64,
                                         n_azimuth=N_AZ, noise=0.01, seed=k)
    img = synthetic.render_camera(scene, T @ calib.imu_T_cam0, calib.K,
                                  IMG_W, IMG_H)
    return scan, np.clip(img * 255.0, 0, 255).astype(np.uint8)


def make_frames():
    from vloam_tpu_torch.data import synthetic

    poses = synthetic.drive_trajectory(N_FRAMES, speed=1.1, yaw_rate=0.01)
    t0 = time.perf_counter()
    workers = max(1, min(8, os.cpu_count() or 1))
    # spawned workers: the parent already holds a CUDA context
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        out = list(pool.map(_render, range(N_FRAMES), poses))
    frames = [f for f, _ in out]
    images = [im for _, im in out]
    print(f"[frames] {N_FRAMES} polar frames 64x{N_AZ} and {IMG_W}x{IMG_H} "
          f"camera images in {time.perf_counter() - t0:.1f} s (host, "
          f"{workers} processes)", flush=True)
    return frames, images, poses


def frame_features(cfg, frames, dirs):
    """Per frame: the K1 inputs (curv, bf, counts) and the features."""
    from vloam_tpu_torch.lidar import scan_registration as sr

    out = []
    for img in frames:
        r = torch.from_numpy(img.astype(np.int32)).cuda()
        pts, _, counts = sr.polar_layout(r, dirs, cfg.lidar)
        curv = sr._curvature(pts)
        bf = sr._break_prefix(pts, cfg.scanreg.neighbor_suppress_gap_sq)
        feats = sr.register_scan_polar(r, dirs, cfg.lidar, cfg.scanreg)
        out.append((curv, bf, counts, feats))
    return out


def k1_phase(cfg, ff) -> dict:
    from vloam_tpu_torch.lidar import scan_registration as sr

    err = 0
    for curv, bf, counts, _ in ff:
        got = sr.select_rings(curv, bf, counts, cfg.scanreg)
        want = sr.select_rings_plain(curv, bf, counts, cfg.scanreg)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"K1 labels differ at {int((got != want).sum())} points")
        err = max(err, int((got - want).abs().max()))
    curv, bf, counts, _ = ff[0]
    ms = cuda_ms(lambda: sr.select_rings(curv, bf, counts, cfg.scanreg))
    plain_ms = cuda_ms(
        lambda: sr.select_rings_plain(curv, bf, counts, cfg.scanreg))
    n_lab = int((got != 0).sum())
    print(f"[3 K1 select_rings] {len(ff)} frames [64,{N_AZ}] labels "
          f"identical ({n_lab} labelled); kernel {ms * 1e3:.1f} us, plain "
          f"{plain_ms * 1e3:.1f} us {clocks()}", flush=True)
    return {"name": "select_rings", "route": "cuda",
            "source": "vloam_tpu_torch/kernels/csrc/select_rings.cu",
            "replaces": "vloam_tpu/lidar/scan_registration.py:261",
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms}


def _k2_check(q, slab_t, what) -> float:
    from vloam_tpu_torch.lidar import ring_assoc as ra

    got = ra.ring_min2(q, slab_t)
    want = ra.ring_min2_plain(q, slab_t)
    torch.cuda.synchronize()
    for i in (1, 3):
        if not torch.equal(got[i], want[i]):
            fail(f"K2 {what}: argmins differ at "
                 f"{int((got[i] != want[i]).sum())} entries")
    err = 0.0
    for i in (0, 2):
        d = (got[i] - want[i]).abs()
        if bool((d > 1e-6 * want[i].abs().clamp(min=1.0)).any()):
            fail(f"K2 {what}: distances differ by up to {float(d.max())}")
        err = max(err, float(d.max()))
    return err


def k2_phase(ff) -> dict:
    from vloam_tpu_torch.lidar import ring_assoc as ra

    err = 0.0
    times = {}
    for k in (1, 2):
        prev, cur = ff[k - 1][3], ff[k][3]
        for what, q, slab in (("corner", cur.sharp.xyz, prev.less_sharp_slab),
                              ("surf", cur.flat.xyz, prev.less_flat_slab)):
            q = q.contiguous()
            slab_t = slab.xyz.transpose(1, 2).contiguous()
            err = max(err, _k2_check(q, slab_t, what))
            times[what] = (q.shape[0], slab_t.shape[2], slab_t,
                           q)
    # crafted: duplicate points (exact ties) and all-SENTINEL rings
    g = torch.Generator().manual_seed(0)
    slab = torch.full((64, 128, 3), ra.SENTINEL)
    slab[::2, :100] = torch.rand((32, 100, 3), generator=g) * 80 - 40
    slab[::4, 50] = slab[::4, 7]
    q = torch.cat([slab[0, 7:8], torch.rand((199, 3), generator=g) * 80 - 40])
    slab_t = slab.transpose(1, 2).contiguous().cuda()
    err = max(err, _k2_check(q.cuda(), slab_t, "ties"))
    got = ra.ring_min2(q.cuda(), slab_t)
    if int(got[1][0, 0]) != 7 or int(got[3][0, 0]) != 50 or \
            int(got[1][1, 5]) != 0 or int(got[3][1, 5]) != 1:
        fail("K2 tie rules")
    line = []
    res = {}
    for what, (Q, C, slab_t, q) in times.items():
        ms = cuda_ms(lambda: ra.ring_min2(q, slab_t))
        plain_ms = cuda_ms(lambda: ra.ring_min2_plain(q, slab_t))
        res[what] = (ms, plain_ms)
        line.append(f"{what} {Q}x[64,3,{C}] kernel {ms * 1e3:.1f} us, "
                    f"plain {plain_ms * 1e3:.1f} us")
    print(f"[4 K2 ring_min2] argmins identical, max |d err| {err:.3g}; "
          + "; ".join(line) + f" {clocks()}", flush=True)
    ms, plain_ms = res["surf"]
    return {"name": "ring_min2", "route": "cuda",
            "source": "vloam_tpu_torch/kernels/csrc/ring_min2.cu",
            "replaces": "vloam_tpu/lidar/ring_assoc.py:86",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def e2e_phase(cfg, frames, poses):
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.lidar.loam_step import LoamEngine, unpack_outputs

    eng = LoamEngine(cfg, chunk=CHUNK, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    for k in range(CHUNK):
        eng.push_polar(frames[k])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the frame loop must never wait on the device: every host sync the
    # timed frames make is recorded and fails the phase
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        for k in range(CHUNK, N_FRAMES):
            eng.push_polar(frames[k])
        torch.cuda.set_sync_debug_mode("default")
    host = time.perf_counter() - t0
    syncs = [str(w.message) for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    clk = clocks()
    outs = eng.finish()
    launches = dict(kernels.LAUNCHES)
    res = unpack_outputs(outs)
    fps = (N_FRAMES - CHUNK) / dt
    gt = np.stack([T[:3, 3] for T in poses])
    err = float(np.linalg.norm(res["t_w_mo"] - gt, axis=1).max())
    err_lo = float(np.linalg.norm(res["t_w_lo"] - gt, axis=1).max())
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"[5 end to end] {N_FRAMES} frames kitti_hdl64 64x{N_AZ}: "
          f"{fps:.2f} frames/s over frames {CHUNK}-{N_FRAMES - 1} "
          f"({dt * 1e3 / (N_FRAMES - CHUNK):.2f} ms/frame, host clock "
          f"between synchronizes; host enqueue "
          f"{host * 1e3 / (N_FRAMES - CHUNK):.2f} ms/frame); launches "
          f"{launches}; max err vs GT LO {err_lo:.4f} m, MO "
          f"{err:.4f} m; peak device memory {peak:.0f} MiB; host syncs in "
          f"the timed frames {len(syncs)} {clk}", flush=True)
    if outs.shape != (N_FRAMES, 24) or not np.isfinite(outs).all():
        fail(f"outputs {outs.shape} not finite")
    if launches["select_rings"] != N_FRAMES or \
            launches["ring_min2"] != 4 * N_FRAMES:
        fail(f"kernel launch counts {launches}")
    if syncs:
        fail(f"the frame loop synchronized with the device: {syncs[:3]}")
    if not err < 0.15:
        fail(f"MO error {err} m >= 0.15 m")
    return res, launches


def cpu_phase(cfg, frames, res_gpu) -> None:
    from vloam_tpu_torch.lidar.loam_step import LoamEngine, unpack_outputs

    t0 = time.perf_counter()
    eng = LoamEngine(cfg, chunk=CPU_FRAMES, device="cpu")
    for k in range(CPU_FRAMES):
        eng.push_polar(frames[k])
    res = unpack_outputs(eng.finish())
    lo = float(np.abs(res["t_w_lo"] - res_gpu["t_w_lo"][:CPU_FRAMES]).max())
    mo = float(np.abs(res["t_w_mo"] - res_gpu["t_w_mo"][:CPU_FRAMES]).max())
    print(f"[6 card vs CPU] first {CPU_FRAMES} frames: max |t_w_lo| diff "
          f"{lo:.2e} m, max |t_w_mo| diff {mo:.2e} m (CPU run "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    if not (lo < 2e-2 and mo < 3e-2):
        fail("card and CPU trajectories disagree")


def k3_phase(cfg, images) -> dict:
    """K3 against its plain version on detected keypoints of 3 rendered
    frames, their last 8 rows replaced by crafted ones: the four image
    corners and a negative x (clipped patches), two keypoints on a constant
    patch (the 1e-3 floor) and one in the middle."""
    from vloam_tpu_torch.vision import features as tf

    crafted = torch.tensor([
        [0.0, 0.0], [IMG_W - 0.1, 0.0], [0.0, IMG_H - 0.1],
        [IMG_W - 0.1, IMG_H - 0.1], [-3.5, 7.2], [20.0, 350.0],
        [40.0, 340.0], [620.4, 187.6]], device="cuda")
    err = 0.0
    n_zero = 0
    inputs = {}
    for k, u8 in enumerate(images[:3]):
        img = torch.from_numpy(u8).cuda().to(torch.float32) / 255.0
        img[300:, :80] = 0.25  # a constant patch at the bottom left
        xy, _, mask = tf.detect_keypoints(img, cfg.vo)
        if int(mask.sum()) < 500:
            fail(f"K3: only {int(mask.sum())} keypoints on frame {k}")
        xy = torch.cat([xy[:-len(crafted)], crafted]).contiguous()
        for p in (24, 16):
            got = tf.zncc_describe(img, xy, p)
            want = tf.zncc_describe_plain(img, xy, p)
            torch.cuda.synchronize()
            zg, zw = (got == 0).all(1), (want == 0).all(1)
            if not torch.equal(zg, zw) or not bool(zg[-3:-1].all()):
                fail(f"K3 p={p}: zero rows differ ({int(zg.sum())} kernel, "
                     f"{int(zw.sum())} plain) or the constant patch is live")
            e = float((got - want).abs().max())
            if not e <= 1e-5:
                fail(f"K3 p={p}: max |err| {e} > 1e-5")
            err = max(err, e)
            n_zero = max(n_zero, int(zg.sum()))
            inputs[p] = (img, xy)
    times = {p: (cuda_ms(lambda: tf.zncc_describe(img, xy, p)),
                 cuda_ms(lambda: tf.zncc_describe_plain(img, xy, p)))
             for p, (img, xy) in inputs.items()}
    print(f"[7 K3 zncc_describe] 3 frames [{IMG_H},{IMG_W}] x "
          f"{len(xy)} keypoints, max |err| {err:.3g} (bound 1e-5), zero rows "
          f"identical (up to {n_zero} a frame); "
          + "; ".join(f"p={p} kernel {k * 1e3:.1f} us, plain {q * 1e3:.1f} us"
                      for p, (k, q) in times.items()) + f" {clocks()}",
          flush=True)
    ms, plain_ms = times[24]
    return {"name": "zncc_describe", "route": "cuda",
            "source": "vloam_tpu_torch/kernels/csrc/zncc_describe.cu",
            "replaces": "vloam_tpu/vision/features.py:411",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def vloam_errors(res, poses, calib) -> dict:
    """LO / MO max position error and the VO ATE (position RMSE in the cam0
    start frame, where both trajectories start at the identity, so no
    alignment) against ground truth, and the fewest 3D-2D matches over
    frames >= 1."""
    gt_w = np.stack([T[:3, 3] for T in poses])
    B = calib.imu_T_cam0
    T0 = poses[0] @ B
    gt_c = np.stack([(np.linalg.inv(T0) @ (T @ B))[:3, 3] for T in poses])
    vo = np.linalg.norm(res["traj_VO"][:, :, 3] - gt_c, axis=1)
    return {"LO": float(np.linalg.norm(res["t_w_lo"] - gt_w, axis=1).max()),
            "MO": float(np.linalg.norm(res["t_w_mo"] - gt_w, axis=1).max()),
            "VO": float(np.sqrt(np.mean(vo ** 2))),
            "n32": int(res["n32"][1:].min())}


def vloam_phase(cfg, frames, images, poses, calib):
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.vloam_step import VloamEngine, unpack_vloam_outputs

    eng = VloamEngine(cfg, calib, chunk=CHUNK, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    for k in range(CHUNK):
        eng.push_polar(frames[k], images[k])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        for k in range(CHUNK, N_FRAMES):
            eng.push_polar(frames[k], images[k])
        torch.cuda.set_sync_debug_mode("default")
    host = time.perf_counter() - t0
    syncs = [str(w.message) for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    clk = clocks()
    outs = eng.finish()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    if outs.shape != (N_FRAMES, 33) or not np.isfinite(outs).all():
        fail(f"combined outputs {outs.shape} not finite")
    res = unpack_vloam_outputs(outs, calib)
    err = vloam_errors(res, poses, calib)
    n = N_FRAMES - CHUNK
    print(f"[8 combined end to end] {N_FRAMES} frames kitti_hdl64 "
          f"detach_VO_LO=False 64x{N_AZ} + {IMG_W}x{IMG_H}: {n / dt:.2f} "
          f"frames/s over frames {CHUNK}-{N_FRAMES - 1} ({dt * 1e3 / n:.2f} "
          f"ms/frame, host clock between synchronizes; host enqueue "
          f"{host * 1e3 / n:.2f} ms/frame); launches {launches}; max err vs "
          f"GT LO {err['LO']:.4f} m, MO {err['MO']:.4f} m; VO ATE vs GT "
          f"{err['VO']:.4f} m; min n32 over frames >= 1 {err['n32']}; "
          f"peak device memory {peak:.0f} MiB; host syncs in the timed "
          f"frames {len(syncs)} {clk}", flush=True)
    want = {"select_rings": N_FRAMES, "ring_min2": 4 * N_FRAMES,
            "zncc_describe": N_FRAMES}
    if launches != want:
        fail(f"kernel launch counts {launches}, want {want}")
    if syncs:
        fail(f"the frame loop synchronized with the device: {syncs[:3]}")
    if not err["MO"] < 0.15:
        fail(f"MO error {err['MO']} m >= 0.15 m")
    if err["n32"] == 0:
        fail("a frame after the first had no depth-backed VO match")
    return res, launches


def vloam_cpu_phase(cfg, frames, images, calib, res_gpu) -> None:
    from vloam_tpu_torch.vloam_step import VloamEngine, unpack_vloam_outputs

    t0 = time.perf_counter()
    n = VLOAM_CPU_FRAMES
    eng = VloamEngine(cfg, calib, chunk=n, device="cpu")
    for k in range(n):
        eng.push_polar(frames[k], images[k])
    res = unpack_vloam_outputs(eng.finish(), calib)
    diff = {w: float(np.abs(res[f"traj_{w}"][:, :, 3]
                            - res_gpu[f"traj_{w}"][:n, :, 3]).max())
            for w in VLOAM_CPU_TOL}
    print(f"[9 combined card vs CPU] first {n} frames: max position diff "
          + ", ".join(f"{w} {d:.2e} m (bound {VLOAM_CPU_TOL[w]:.0e})"
                      for w, d in diff.items())
          + f"; n32 {res['n32'].tolist()} vs {res_gpu['n32'][:n].tolist()} "
          f"(CPU run {time.perf_counter() - t0:.1f} s)", flush=True)
    if any(not diff[w] < VLOAM_CPU_TOL[w] for w in diff):
        fail("card and CPU trajectories of the combined engine disagree")


_KERNELS = ("select_rings_kernel", "ring_min2_kernel", "zncc_describe_kernel")


def _profile(push, first: int) -> dict:
    """torch.profiler over PROFILE_FRAMES frames pushed after `first`
    frames: per frame, CUDA kernel launches, device kernels, device kernel
    time, host enqueue and wall time; and the device time per launch of
    each hand-written kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for k in range(first):
        push(k)
    torch.cuda.synchronize()
    n = PROFILE_FRAMES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(first, first + n):
            push(k)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    per_launch = {}
    for name in _KERNELS:
        hits = [e for e in dev if name in e.key]
        count = sum(e.count for e in hits)
        if count:
            per_launch[name] = (sum(e.self_device_time_total for e in hits)
                                / count)
    return {
        "kernel_us": per_launch,
        "launches": sum(e.count for e in ka if e.key.startswith(
            ("cudaLaunchKernel", "cuLaunchKernel"))) / n,
        "device_kernels": sum(e.count for e in dev) / n,
        "device_ms": sum(e.self_device_time_total for e in dev) / 1e3 / n,
        "host_ms": host * 1e3 / n, "wall_ms": wall * 1e3 / n}


def profile_phase(cfg, cfg_v, frames, images, calib) -> None:
    from vloam_tpu_torch.lidar.loam_step import LoamEngine
    from vloam_tpu_torch.vloam_step import VloamEngine

    lo = LoamEngine(cfg, chunk=PROFILE_FRAMES, device="cuda")
    vl = VloamEngine(cfg_v, calib, chunk=PROFILE_FRAMES, device="cuda")
    stats = {
        "LoamEngine": _profile(lambda k: lo.push_polar(frames[k]),
                               PROFILE_FRAMES),
        "VloamEngine": _profile(
            lambda k: vl.push_polar(frames[k], images[k]), PROFILE_FRAMES)}
    lo.finish()
    vl.finish()
    print("[10 launches per frame] torch.profiler over frames "
          f"{PROFILE_FRAMES}-{2 * PROFILE_FRAMES - 1}, chunk {PROFILE_FRAMES}"
          " (profiler on): " + "; ".join(
              f"{name} {s['launches']:.0f} kernel launches, "
              f"{s['device_kernels']:.0f} device kernels, device "
              f"{s['device_ms']:.2f} ms, host enqueue {s['host_ms']:.2f} ms, "
              f"wall {s['wall_ms']:.2f} ms; device us per launch "
              + ", ".join(f"{k.split('_kernel')[0]} {v:.1f}"
                          for k, v in s["kernel_us"].items())
              for name, s in stats.items()), flush=True)


def main() -> None:
    card = device_phase()
    build_phase()
    from vloam_tpu_torch.config import kitti_hdl64
    from vloam_tpu_torch.data.synthetic import hdl64_elevations
    from vloam_tpu_torch.lidar.scan_registration import polar_directions

    cfg = kitti_hdl64()
    cfg_v = cfg.replace(detach_VO_LO=False)
    calib = Calib()
    frames, images, poses = make_frames()
    elev = torch.tensor(np.radians(hdl64_elevations(64)),
                        dtype=torch.float32, device="cuda")
    ff = frame_features(cfg, frames[:3], polar_directions(elev, N_AZ))
    warm_up()
    k1 = k1_phase(cfg, ff)
    k2 = k2_phase(ff)
    del ff
    res_gpu, _ = e2e_phase(cfg, frames, poses)
    cpu_phase(cfg, frames, res_gpu)
    k3 = k3_phase(cfg_v, images)
    res_v, launches = vloam_phase(cfg_v, frames, images, poses, calib)
    vloam_cpu_phase(cfg_v, frames, images, calib, res_v)
    profile_phase(cfg, cfg_v, frames, images, calib)
    # launches: the combined engine's run (phase 8), which drives all three
    k1["launches"] = launches["select_rings"]
    k2["launches"] = launches["ring_min2"]
    k3["launches"] = launches["zncc_describe"]
    print(json.dumps({"kernels": [k1, k2, k3]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
