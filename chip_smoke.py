"""Drive the PyTorch port's main paths once on one NVIDIA GPU: the LiDAR-only
LOAM engine, the combined camera + LiDAR engine and the 4-stream lockstep
batch engine.

    python3 chip_smoke.py

Phases (one line each; any failure ends the run with a nonzero exit):
  1. device: the card's name and power limit; CUDA required, TF32 off
  2. build: compile the hand-written kernels from kernels/csrc with nvcc;
     ptxas' registers, spills and shared memory of K1 and K2
  frames: a 32-frame synthetic HDL-64 polar drive (64 x 1800) with its
     1242 x 375 camera images, and three more 20-frame polar drives for the
     batch engine's other streams, rendered in worker processes
  warm-up: ~3 s of matmuls so that the timed phases start on a busy card
  3. K1 select_rings vs its plain PyTorch version on real frame layouts and
     on the crafted cases of vloam_tpu_torch/tools/kernel_cases.py (windows
     that cross a sector's end, chains of such, equal curvatures, short
     rings, NaN, widths up to 7000)
  4. K2 ring_min2 and S1 ring_min1 / ring_argmin2 vs their plain versions at
     the corner and surf LO shapes on real frame features, on crafted ties,
     on K2's crafted cases (duplicates across chunk and tile boundaries,
     SENTINEL slots between live ones, counts that fit no tile) and at the
     two shapes of the ring-variants measurement
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
  10. batch end to end: BatchLoamEngine(kitti_hdl64(), 4, chunk=4,
     device="cuda") over 20 lockstep frames of 4 drives; aggregate frames/s
     beside the single engine's on the same frames, launches per lockstep
     frame, MO error per stream, each stream against its single-engine run,
     no host sync
  11. the first 2 lockstep frames of 2 streams again on the CPU
  S2. row_gather vs table[idx] (bit-identical) and torch.index_select on the
     four gathers of a real frame of the single engine (probe 16384 x 96 and
     49152 x 48 floats from [2^17, W] tables, insert 2048 and 6144 rows), on
     the four of a lockstep frame of the batch engine (4x the rows, from the
     flat [4 * 2^17, W] tables, ids carrying the stream offsets) and at
     [2^17, 96] x 65536 random
  12. the ring-variants measurement entry point (ring_argmin2's path): its
     check against the plain version and its times
  13. launches per frame: torch.profiler over steady frames of each engine
     (printed, not gated: the profiler can lose records)
Timed phases end with the SM clock, its maximum, the power draw and the
temperature that nvidia-smi reads just after their timed runs. Then the
kernels' JSON line, the card's line and, last, the device line. Each row of
the kernels' line takes its times and its bound at the shapes of the path
that its launches are counted on: the batch drive (phase 10) for
select_rings, ring_min2, ring_min1 (per stream: the single engine's shapes)
and row_gather (the flat surf probe), the combined engine (phase 8) for
zncc_describe, the ring-variants entry point (phase 12) for ring_argmin2.

Kernel times are device times (vloam_tpu_torch.tools.timing.device_ms: CUDA
events around 20 calls queued behind a blocker, so the ~30 us host call of a
wrapper is not in them), with a cold L2 for the memory-bound kernels (K1,
K3, S2; device_ms's default) and a warm one for the ring reductions.

Imports nothing of JAX or of the JAX package: the configuration and the
synthetic scene generator are the port's own (vloam_tpu_torch.config,
vloam_tpu_torch.data.synthetic).
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

N_FRAMES = 32
CHUNK = 16
BATCH = 4  # streams of the batch drive
BATCH_FRAMES = 20  # lockstep frames: one warm chunk, then 16 timed
BATCH_CHUNK = 4
BATCH_CPU = (2, 2)  # streams, lockstep frames of the card-vs-CPU check
# batch engine against the single engine per stream, in metres (the bounds of
# tests/test_batch_engine.py), and against its own CPU run (as phase 6)
BATCH_SINGLE_TOL = {"LO": 1e-3, "MO": 1e-2}
BATCH_CPU_TOL = {"LO": 2e-2, "MO": 3e-2}
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


S1_REPLACES = "scripts/profile_ring_variants.py:73"
# Device times in us of the first K1 and K2, which the present kernels
# replaced: one block per ring with a block-wide argmax per round, and one
# query per thread (NVIDIA H100 80GB HBM3 at 700 W, the same method and
# shapes as phases 3 and 4; PERF.md section 6). Printed beside the new times.
K1_BEFORE_US = 117.0
K2_BEFORE_US = {"surf": 44.6, "corner": 8.3}


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


def io_bytes(*tensors) -> int:
    """Bytes of the given inputs and outputs, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_row(name, source, replaces, err, ms, plain_ms, bound,
               library_ms=None) -> dict:
    bound_ms, bound_by = bound
    return {"name": name, "route": "cuda",
            "source": f"vloam_tpu_torch/kernels/csrc/{source}",
            "replaces": replaces, "max_abs_err": float(err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def device_phase() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from vloam_tpu_torch.tools.timing import card_line

    card = card_line()
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
    usage = {**build.resource_usage("select_rings_kernel"),
             **build.resource_usage("ring_min2_kernel")}
    if not usage:
        fail("no ptxas report for K1 and K2 in the build log")
    print(f"[2 build] {lib.name} in {time.perf_counter() - t0:.2f} s; ptxas: "
          + "; ".join(
              f"{name} {u['registers']} registers, {u['spill_stores']} + "
              f"{u['spill_loads']} B spilled, {u['stack']} B stack, "
              f"{u['smem']} B static shared"
              for name, u in sorted(usage.items())), flush=True)
    if any(u["spill_stores"] or u["spill_loads"] for u in usage.values()):
        fail("a redesigned kernel spills registers")


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


def _scan(seed: int, T: np.ndarray) -> np.ndarray:
    """One polar scan of the scene from sensor pose T."""
    from vloam_tpu_torch.data import synthetic

    return synthetic.simulate_scan_polar(
        synthetic.urban_scene(0, extent=80.0), T, n_scans=64, n_azimuth=N_AZ,
        noise=0.01, seed=seed)


def _render(k: int, T: np.ndarray):
    """Frame k: the polar scan and the camera image from sensor pose T."""
    from vloam_tpu_torch.data import synthetic

    calib = Calib()
    img = synthetic.render_camera(synthetic.urban_scene(0, extent=80.0),
                                  T @ calib.imu_T_cam0, calib.K, IMG_W, IMG_H)
    return _scan(k, T), np.clip(img * 255.0, 0, 255).astype(np.uint8)


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
        # the batch engine's other streams: other yaw rates, other noise
        streams, stream_poses = [frames[:BATCH_FRAMES]], [poses[:BATCH_FRAMES]]
        for b in range(1, BATCH):
            ps = synthetic.drive_trajectory(
                BATCH_FRAMES, speed=1.1 - 0.1 * b,
                yaw_rate=0.01 * (-1) ** b * (b + 1))
            streams.append(list(pool.map(
                _scan, range(1000 * b, 1000 * b + BATCH_FRAMES), ps)))
            stream_poses.append(ps)
    print(f"[frames] {N_FRAMES} polar frames 64x{N_AZ} and {IMG_W}x{IMG_H} "
          f"camera images, {BATCH - 1} x {BATCH_FRAMES} more polar frames in "
          f"{time.perf_counter() - t0:.1f} s (host, {workers} processes)",
          flush=True)
    return frames, images, poses, streams, stream_poses


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
    from vloam_tpu_torch.tools import kernel_cases, timing

    err = 0
    for curv, bf, counts, _ in ff:
        got = sr.select_rings(curv, bf, counts, cfg.scanreg)
        want = sr.select_rings_plain(curv, bf, counts, cfg.scanreg)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"K1 labels differ at {int((got != want).sum())} points")
        err = max(err, int((got - want).abs().max()))
    n_lab = int((got != 0).sum())
    cases = kernel_cases.select_rings_cases()
    for case in cases:
        c, b, n = (torch.from_numpy(a).cuda()
                   for a in (case.curv, case.bf, case.counts))
        got_c = sr.select_rings(c, b, n, cfg.scanreg)
        want_c = sr.select_rings_plain(c, b, n, cfg.scanreg)
        torch.cuda.synchronize()
        if not torch.equal(got_c, want_c):
            fail(f"K1 labels differ at {int((got_c != want_c).sum())} points "
                 f"of the crafted case {case.name}")
    curv, bf, counts, _ = ff[0]
    ms = timing.device_ms(
        lambda: sr.select_rings(curv, bf, counts, cfg.scanreg))
    plain_ms = timing.device_ms(
        lambda: sr.select_rings_plain(curv, bf, counts, cfg.scanreg), runs=5,
        cold=False)
    # each input and the labels once; per ring 2 x 24 rounds of one compare
    # per point (the sector's running extremum)
    bound = timing.bound_ms(io_bytes(curv, bf, counts, got),
                            2 * 24 * curv.numel())
    print(f"[3 K1 select_rings] {len(ff)} frames [64,{N_AZ}] labels "
          f"identical ({n_lab} labelled), and on {len(cases)} crafted cases ("
          + ", ".join(c.name for c in cases) + f"); kernel {ms * 1e3:.1f} us "
          f"({K1_BEFORE_US} us before the redesign), plain "
          f"{plain_ms * 1e3:.1f} us, bound by {bound[1]} "
          f"{bound[0] * 1e3:.2f} us {clocks()}", flush=True)
    return kernel_row("select_rings", "select_rings.cu",
                      "vloam_tpu/lidar/scan_registration.py:261", err, ms,
                      plain_ms, bound)


def _ring_check(q, slab_t, what, errs) -> None:
    """K2 and both S1 kernels against the plain versions on the card: every
    slot and every distance identical (all round (dx^2 + dy^2) + dz^2 alike),
    so ring_argmin2 equals K2 and ring_min1 its first half. Raises each
    kernel's entry of errs to its largest |difference| over all outputs."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.lidar import ring_assoc as ra

    want = ra.ring_min2_plain(q, slab_t)
    want1 = ra.ring_min1_plain(q, slab_t)
    got = {"ring_min2": (ra.ring_min2(q, slab_t), want),
           "ring_argmin2": (kernels.ring_argmin2(q, slab_t), want),
           "ring_min1": (ra.ring_min1(q, slab_t), want1)}
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(want1, want[:2])):
        fail(f"{what}: ring_min1_plain is not ring_min2_plain's first half")
    for name, (outs, ref) in got.items():
        for i, (g, w) in enumerate(zip(outs, ref)):
            errs[name] = max(errs[name], float((g - w).abs().max()))
            if not torch.equal(g, w):
                fail(f"{name} {what}: output {i} differs at "
                     f"{int((g != w).sum())} entries, max {errs[name]}")


def ring_phase(ff) -> tuple[dict, dict, float]:
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.lidar import ring_assoc as ra
    from vloam_tpu_torch.tools import kernel_cases, timing
    from vloam_tpu_torch.tools import profile_ring_variants as prv

    shapes = {}
    errs = {"ring_min2": 0.0, "ring_min1": 0.0, "ring_argmin2": 0.0}
    for k in (1, 2):
        prev, cur = ff[k - 1][3], ff[k][3]
        for what, q, slab in (("corner", cur.sharp.xyz, prev.less_sharp_slab),
                              ("surf", cur.flat.xyz, prev.less_flat_slab)):
            q = q.contiguous()
            slab_t = slab.xyz.transpose(1, 2).contiguous()
            _ring_check(q, slab_t, what, errs)
            shapes[what] = (q, slab_t)
    # crafted: duplicate points (exact ties) and all-SENTINEL rings
    g = torch.Generator().manual_seed(0)
    slab = torch.full((64, 128, 3), ra.SENTINEL)
    slab[::2, :100] = torch.rand((32, 100, 3), generator=g) * 80 - 40
    slab[::4, 50] = slab[::4, 7]
    q = torch.cat([slab[0, 7:8], torch.rand((199, 3), generator=g) * 80 - 40])
    slab_t = slab.transpose(1, 2).contiguous().cuda()
    _ring_check(q.cuda(), slab_t, "ties", errs)
    for fn in (ra.ring_min2, kernels.ring_argmin2):
        got = fn(q.cuda(), slab_t)
        if int(got[1][0, 0]) != 7 or int(got[3][0, 0]) != 50 or \
                int(got[1][1, 5]) != 0 or int(got[3][1, 5]) != 1:
            fail(f"{fn.__name__} tie rules")
    got = ra.ring_min1(q.cuda(), slab_t)
    if int(got[1][0, 0]) != 7 or int(got[1][1, 5]) != 0:
        fail("ring_min1 tie rules")
    cases = kernel_cases.ring_min2_cases()
    for case in cases:
        _ring_check(torch.from_numpy(case.queries).cuda(),
                    torch.from_numpy(case.slab_t).cuda(),
                    f"crafted case {case.name}", errs)
    for name, S, C, Q in prv.SHAPES:
        _ring_check(*prv.make(S, C, Q), f"measurement shape {name}", errs)

    fns = {"ring_min2": (ra.ring_min2, ra.ring_min2_plain, 4),
           "ring_min1": (ra.ring_min1, ra.ring_min1_plain, 2),
           "ring_argmin2": (kernels.ring_argmin2, ra.ring_min2_plain, 4)}
    res, line = {}, []
    for what, (q, slab_t) in shapes.items():
        Q, S, C = q.shape[0], slab_t.shape[0], slab_t.shape[2]
        for name, (fn, plain, n_out) in fns.items():
            res[name, what] = (
                timing.device_ms(lambda: fn(q, slab_t), cold=False),
                timing.device_ms(lambda: plain(q, slab_t), runs=10,
                                 cold=False),
                timing.ring_reduce_bound(Q, S, C, n_out))
        line.append(f"{what} {Q}x[{S},3,{C}] " + ", ".join(
            f"{name} {res[name, what][0] * 1e3:.1f} us (plain "
            f"{res[name, what][1] * 1e3:.1f}, bound "
            f"{res[name, what][2][0] * 1e3:.2f})" for name in fns))
    clk = clocks()
    share = prv.update_share(*shapes["surf"])
    print("[4 K2 ring_min2, S1 ring_min1 / ring_argmin2] slots and distances "
          f"identical to the plain versions (real features, ties, "
          f"{len(cases)} crafted cases: "
          + ", ".join(c.name for c in cases) + "; measurement shapes); "
          "device time " + "; ".join(line) + "; ring_min2 before the "
          "redesign " + ", ".join(f"{w} {t} us"
                                  for w, t in K2_BEFORE_US.items())
          + "; chunks of 8 surf slots whose minimum is below the running "
          f"second minimum: {share[0]:.1%} per query, {share[1]:.1%} per "
          f"warp of 128 queries {clk}", flush=True)
    # each engine kernel's row at the shape its path gives it, per stream
    # in the batch drive as in the single engine: K2 surf, ring_min1 corner.
    # ring_argmin2's times come from its own path, the ring-variants entry
    # point (phase 12), which gets its |difference| from here
    return [
        kernel_row("ring_min2", "ring_min2.cu",
                   "vloam_tpu/lidar/ring_assoc.py:86", errs["ring_min2"],
                   *res["ring_min2", "surf"]),
        kernel_row("ring_min1", "ring_min1.cu", S1_REPLACES,
                   errs["ring_min1"], *res["ring_min1", "corner"]),
        errs["ring_argmin2"]]


def _sync_free(push, ks):
    """Run push(k) for k in ks with every host sync recorded; returns (host
    enqueue seconds, the sync warnings)."""
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        for k in ks:
            push(k)
        torch.cuda.set_sync_debug_mode("default")
    host = time.perf_counter() - t0
    return host, [str(w.message) for w in caught
                  if "synchronizing CUDA operation" in str(w.message)]


def lidar_launches(n: int, **more) -> dict:
    """Launches of n single-stream frames: K1 once; LO associates twice per
    frame (K2 for surf, ring_min1 for corner each time); the mapping stage
    gathers rows 4 times (2 probes, 2 inserts)."""
    return {"select_rings": n, "ring_min2": 2 * n, "ring_min1": 2 * n,
            "row_gather": 4 * n, "zncc_describe": 0, "ring_argmin2": 0,
            **more}


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
    host, syncs = _sync_free(lambda k: eng.push_polar(frames[k]),
                             range(CHUNK, N_FRAMES))
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
    want = lidar_launches(N_FRAMES)
    if launches != want:
        fail(f"kernel launch counts {launches}, want {want}")
    if syncs:
        fail(f"the frame loop synchronized with the device: {syncs[:3]}")
    if not err < 0.15:
        fail(f"MO error {err} m >= 0.15 m")
    return res, eng


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


def _capture_gathers(run):
    """The (table, idx) arguments of every row gather that run() makes, in
    the single-stream map (gridmap) and in the flat batch map
    (batch_mapping, which binds the dispatcher under its own name)."""
    from vloam_tpu_torch.lidar import batch_mapping, gridmap

    seen = []
    real = gridmap.row_gather

    def recorder(table, idx):
        seen.append((table, idx))
        return real(table, idx)

    gridmap.row_gather = batch_mapping.row_gather = recorder
    try:
        run()
    finally:
        gridmap.row_gather = batch_mapping.row_gather = real
    torch.cuda.synchronize()
    return seen


_GATHERS = ("corner probe", "surf probe", "corner insert", "surf insert")


def s2_phase(eng, frame, beng, streams) -> dict:
    """S2 against its plain version on the four gathers of one more real
    frame through the phase-5 engine (its map holds the whole drive), on the
    four of one more lockstep frame through the phase-10 batch engine (flat
    tables of all streams, ids with stream offsets) and at the measurement's
    [2^17, 96] x 65536 random shape."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.lidar import gridmap
    from vloam_tpu_torch.tools import profile_row_gather as prg
    from vloam_tpu_torch.tools import timing

    def one_frame():
        eng.push_polar(frame)
        eng.finish()

    def one_lockstep_frame():
        _lockstep(beng, streams, [BATCH_FRAMES - 1])
        beng.finish()

    nb = 1 << 17
    cases = []
    for who, run, B in (("frame", one_frame, 1),
                        ("batch", one_lockstep_frame, BATCH)):
        seen = _capture_gathers(run)
        shapes = [(tuple(t.shape), len(i)) for t, i in seen]
        want = [((B * nb, 96), B * 16384), ((B * nb, 48), B * 49152),
                ((B * nb, 96), B * 2048), ((B * nb, 48), B * 6144)]
        if shapes != want:
            fail(f"S2: the {who} gathers are {shapes}, want {want}")
        cases += [(f"{who} {what}", t, i) for what, (t, i) in zip(_GATHERS,
                                                                  seen)]
    # the batch probe really spans the streams' tables
    top = int(cases[5][2].max()) // nb
    if top != BATCH - 1:
        fail(f"S2: the batch surf probe's highest row is in stream {top}")
    cases.append(("random", *prg.make()))
    line, rows, err = [], {}, 0.0
    for what, table, idx in cases:
        got = gridmap.row_gather(table, idx)
        want = gridmap.row_gather_plain(table, idx)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            fail(f"S2 {what}: differs from table[idx] at "
                 f"{int((got != want).sum())} elements")
        live = float((got[:, 0] < 1e5).float().mean())
        ms = timing.device_ms(lambda: kernels.row_gather(table, idx))
        warm = timing.device_ms(lambda: kernels.row_gather(table, idx),
                                cold=False)
        plain = timing.device_ms(
            lambda: gridmap.row_gather_plain(table, idx))
        lib = timing.device_ms(lambda: torch.index_select(table, 0, idx))
        n_unique = len(torch.unique(idx))
        bound = timing.row_gather_bound(len(idx), table.shape[1], n_unique)
        rows[what] = (ms, plain, bound, lib)
        line.append(f"{what} {len(idx)} x {table.shape[1]} f32 of "
                    f"{table.shape[0]} ({n_unique} distinct rows, "
                    f"{live:.0%} live): kernel {ms * 1e3:.1f} us "
                    f"({warm * 1e3:.1f} warm L2), table[idx] "
                    f"{plain * 1e3:.1f}, index_select {lib * 1e3:.1f}, "
                    f"bound {bound[0] * 1e3:.1f}")
    print("[S2 row_gather] bit-identical to table[idx]; device time, cold "
          "L2: " + "; ".join(line) + f" {clocks()}", flush=True)
    # the row: the largest gather of the path the launches are counted on,
    # the batch drive's flat surf probe
    return kernel_row("row_gather", "row_gather.cu",
                      "scripts/profile_pallas_gather.py:55", err,
                      *rows["batch surf probe"])


def _lockstep(eng, streams, ks) -> None:
    for k in ks:
        for b, frames in enumerate(streams):
            eng.push_polar(b, frames[k])


def batch_phase(cfg, streams, stream_poses):
    """4 streams in lockstep through BatchLoamEngine, then each stream alone
    through LoamEngine over the same frames, in turns on the same card."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.lidar.loam_step import (BatchLoamEngine, LoamEngine,
                                                 unpack_outputs)

    n_timed = BATCH_FRAMES - BATCH_CHUNK
    eng = BatchLoamEngine(cfg, BATCH, chunk=BATCH_CHUNK, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    _lockstep(eng, streams, range(BATCH_CHUNK))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host, syncs = _sync_free(lambda k: _lockstep(eng, streams, [k]),
                             range(BATCH_CHUNK, BATCH_FRAMES))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    clk = clocks()
    outs = eng.finish()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    if outs.shape != (BATCH, BATCH_FRAMES, 24) or not np.isfinite(outs).all():
        fail(f"batch outputs {outs.shape} not finite")

    single_dt, errs, diffs = [], [], []
    for b in range(BATCH):
        one = LoamEngine(cfg, chunk=BATCH_CHUNK, device="cuda")
        for k in range(BATCH_CHUNK):
            one.push_polar(streams[b][k])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(BATCH_CHUNK, BATCH_FRAMES):
            one.push_polar(streams[b][k])
        torch.cuda.synchronize()
        single_dt.append(time.perf_counter() - t0)
        ref = unpack_outputs(one.finish())
        res = unpack_outputs(outs[b])
        gt = np.stack([T[:3, 3] for T in stream_poses[b]])
        errs.append(float(np.linalg.norm(res["t_w_mo"] - gt, axis=1).max()))
        diffs.append({w: float(np.abs(res[f"t_w_{w.lower()}"]
                                      - ref[f"t_w_{w.lower()}"]).max())
                      for w in BATCH_SINGLE_TOL})
    fps = BATCH * n_timed / dt
    single_fps = BATCH * n_timed / sum(single_dt)
    per_frame = {k: v / BATCH_FRAMES for k, v in launches.items() if v}
    print(f"[10 batch end to end] {BATCH} streams x {BATCH_FRAMES} lockstep "
          f"frames kitti_hdl64 64x{N_AZ}, chunk {BATCH_CHUNK}: {fps:.2f} "
          f"stream-frames/s over lockstep frames {BATCH_CHUNK}-"
          f"{BATCH_FRAMES - 1} ({dt * 1e3 / n_timed:.2f} ms per lockstep "
          f"frame, host enqueue {host * 1e3 / n_timed:.2f} ms) against "
          f"{single_fps:.2f} frames/s of LoamEngine over the same frames, one "
          f"stream after the other ({fps / single_fps:.2f}x); launches per "
          f"lockstep frame {per_frame}; MO max err vs GT per stream "
          + ", ".join(f"{e:.4f}" for e in errs) + " m; batch vs single max "
          "diff per stream " + ", ".join(
              f"LO {d['LO']:.2e} MO {d['MO']:.2e}" for d in diffs)
          + f" m; peak device memory {peak:.0f} MiB; host syncs in the timed "
          f"frames {len(syncs)} {clk}", flush=True)
    want = lidar_launches(BATCH * BATCH_FRAMES, row_gather=4 * BATCH_FRAMES)
    if launches != want:
        fail(f"batch kernel launch counts {launches}, want {want}")
    if syncs:
        fail(f"the batch loop synchronized with the device: {syncs[:3]}")
    if not max(errs) < 0.15:
        fail(f"batch MO error {max(errs)} m >= 0.15 m")
    for d in diffs:
        if any(not d[w] < BATCH_SINGLE_TOL[w] for w in d):
            fail(f"batch and single engines disagree: {diffs}")
    return outs, launches, eng


def batch_cpu_phase(cfg, streams, outs_gpu) -> None:
    from vloam_tpu_torch.lidar.loam_step import (BatchLoamEngine,
                                                 unpack_outputs)

    nb, nf = BATCH_CPU
    t0 = time.perf_counter()
    eng = BatchLoamEngine(cfg, nb, chunk=nf, device="cpu")
    _lockstep(eng, streams[:nb], range(nf))
    outs = eng.finish()
    diff = {"LO": 0.0, "MO": 0.0}
    for b in range(nb):
        res, ref = unpack_outputs(outs[b]), unpack_outputs(outs_gpu[b][:nf])
        for w in diff:
            key = f"t_w_{w.lower()}"
            diff[w] = max(diff[w], float(np.abs(res[key] - ref[key]).max()))
    print(f"[11 batch card vs CPU] first {nf} lockstep frames of {nb} "
          "streams: max position diff "
          + ", ".join(f"{w} {d:.2e} m (bound {BATCH_CPU_TOL[w]:.0e})"
                      for w, d in diff.items())
          + f" (CPU run {time.perf_counter() - t0:.1f} s)", flush=True)
    if any(not diff[w] < BATCH_CPU_TOL[w] for w in diff):
        fail("card and CPU trajectories of the batch engine disagree")


def ring_variants_phase(err: float) -> dict:
    """The measurement entry point that launches ring_argmin2: its path. It
    holds every variant against the plain version before it times them;
    ring_argmin2's row takes its times at the entry point's surf shape."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.tools import profile_ring_variants as prv
    from vloam_tpu_torch.tools import timing

    kernels.reset_launches()
    print("[12 ring variants entry point]", flush=True)
    ms = prv.run(runs=10)
    n = kernels.LAUNCHES["ring_argmin2"]
    if not (n > 0 and kernels.LAUNCHES["ring_min1"] > 0
            and kernels.LAUNCHES["ring_min2"] > 0):
        fail(f"the ring-variants entry point launched {kernels.LAUNCHES}")
    name, S, C, Q = prv.SHAPES[1]
    row = kernel_row("ring_argmin2", "ring_min1.cu", S1_REPLACES, err,
                     ms[name]["ring_argmin2"], ms[name]["plain min2"],
                     timing.ring_reduce_bound(Q, S, C, 4))
    row["launches"] = n
    return row


def k3_phase(cfg, images) -> dict:
    """K3 against its plain version on detected keypoints of 3 rendered
    frames, their last 8 rows replaced by crafted ones: the four image
    corners and a negative x (clipped patches), two keypoints on a constant
    patch (the 1e-3 floor) and one in the middle."""
    from vloam_tpu_torch.tools import timing
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
    times = {p: (timing.device_ms(lambda: tf.zncc_describe(img, xy, p)),
                 timing.device_ms(
                     lambda: tf.zncc_describe_plain(img, xy, p)))
             for p, (img, xy) in inputs.items()}
    # the main path's patch size (cfg.vo's 24): image, keypoints and
    # descriptors once; per descriptor element a bilinear sample (7
    # operations) and 2 for each of mean and norm
    img, xy = inputs[24]
    n_desc = len(xy) * 24 * 24
    bound = timing.bound_ms(io_bytes(img, xy) + 4 * n_desc, 11 * n_desc)
    print(f"[7 K3 zncc_describe] 3 frames [{IMG_H},{IMG_W}] x "
          f"{len(xy)} keypoints, max |err| {err:.3g} (bound 1e-5), zero rows "
          f"identical (up to {n_zero} a frame); "
          + "; ".join(f"p={p} kernel {k * 1e3:.1f} us, plain {q * 1e3:.1f} us"
                      for p, (k, q) in times.items())
          + f"; bound by {bound[1]} {bound[0] * 1e3:.2f} us (p=24) {clocks()}",
          flush=True)
    return kernel_row("zncc_describe", "zncc_describe.cu",
                      "vloam_tpu/vision/features.py:411", err, *times[24],
                      bound)


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
    host, syncs = _sync_free(lambda k: eng.push_polar(frames[k], images[k]),
                             range(CHUNK, N_FRAMES))
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
    want = lidar_launches(N_FRAMES, zncc_describe=N_FRAMES)
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


_KERNELS = ("select_rings_kernel", "ring_min2_kernel", "ring_min1_kernel",
            "row_gather_kernel", "zncc_describe_kernel")


def _profile(push, first: int, n: int = PROFILE_FRAMES) -> dict:
    """torch.profiler over n frames pushed after `first` frames: per frame,
    CUDA kernel launches, device kernels, device kernel
    time, host enqueue and wall time; and the device time per launch of
    each hand-written kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for k in range(first):
        push(k)
    torch.cuda.synchronize()
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


def profile_phase(cfg, cfg_v, frames, images, calib, streams) -> None:
    from vloam_tpu_torch.lidar.loam_step import BatchLoamEngine, LoamEngine
    from vloam_tpu_torch.vloam_step import VloamEngine

    lo = LoamEngine(cfg, chunk=PROFILE_FRAMES, device="cuda")
    vl = VloamEngine(cfg_v, calib, chunk=PROFILE_FRAMES, device="cuda")
    ba = BatchLoamEngine(cfg, BATCH, chunk=BATCH_CHUNK, device="cuda")
    stats = {
        "LoamEngine": _profile(lambda k: lo.push_polar(frames[k]),
                               PROFILE_FRAMES),
        "VloamEngine": _profile(
            lambda k: vl.push_polar(frames[k], images[k]), PROFILE_FRAMES),
        f"BatchLoamEngine x{BATCH} (per lockstep frame, frames "
        f"{PROFILE_FRAMES}-{PROFILE_FRAMES + BATCH_CHUNK - 1}, chunk "
        f"{BATCH_CHUNK})": _profile(
            lambda k: _lockstep(ba, streams, [k]), PROFILE_FRAMES,
            BATCH_CHUNK)}
    lo.finish()
    vl.finish()
    ba.finish()
    print("[13 launches per frame] torch.profiler over frames "
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
    frames, images, poses, streams, stream_poses = make_frames()
    elev = torch.tensor(np.radians(hdl64_elevations(64)),
                        dtype=torch.float32, device="cuda")
    ff = frame_features(cfg, frames[:3], polar_directions(elev, N_AZ))
    warm_up()
    k1 = k1_phase(cfg, ff)
    k2, s1_min1, err_argmin2 = ring_phase(ff)
    del ff
    res_gpu, eng = e2e_phase(cfg, frames, poses)
    cpu_phase(cfg, frames, res_gpu)
    k3 = k3_phase(cfg_v, images)
    res_v, launches_v = vloam_phase(cfg_v, frames, images, poses, calib)
    vloam_cpu_phase(cfg_v, frames, images, calib, res_v)
    outs_b, launches_b, beng = batch_phase(cfg, streams, stream_poses)
    batch_cpu_phase(cfg, streams, outs_b)
    s2 = s2_phase(eng, frames[N_FRAMES - 1], beng, streams)
    del eng, beng
    s1_argmin2 = ring_variants_phase(err_argmin2)
    profile_phase(cfg, cfg_v, frames, images, calib, streams)
    # launches: each kernel's count over the run of the path that drives it,
    # with the counts set to 0 just before: the batch drive (phase 10), the
    # combined engine (phase 8) for K3, the ring-variants entry point (phase
    # 12) for ring_argmin2
    for row in (k1, k2, s1_min1, s2):
        row["launches"] = launches_b[row["name"]]
    k3["launches"] = launches_v["zncc_describe"]
    kernels = [k1, k2, k3, s2, s1_min1, s1_argmin2]
    if any(not row["launches"] > 0 for row in kernels):
        fail(f"a kernel was never launched on its path: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
