"""Frames a second of the port's fused LOAM pipeline on one card: the
counterpart of bench.py and scripts/bench_extras.py.

    python -m vloam_tpu_torch.tools.bench [--device cpu]

LoamEngine(kitti_hdl64(), chunk=16) takes bench.py's frames through
push_polar: synthetic HDL-64 range images (64 x 1800, uint16 at 5 mm) of
urban_scene(0, extent=80) along drive_trajectory(112, speed=1.1,
yaw_rate=0.01), 16 warm-up frames and 96 measured ones. Three windows of
96 frames, each ended by a fresh torch.cuda.synchronize() (the fence is
timed on its own, with nothing queued: fence_ms); `value` is the best
window's frames/s and vs_baseline value / 10 (the reference's 10 frames/s,
lidar_odometry_mapping.cpp:150-153). device_ms_per_frame: the engine's
chunk step on range images already on the card; upload_mbps: three 4 MB
host-to-card copies. The secondary numbers: combined_fps, VloamEngine
with detach_VO_LO=False over the first 40 of the same frames and their
rendered 1242 x 375 images (8 warm-up frames, three windows of 32;
vs_baseline against the reference's 6.8 frames/s), and
pose_graph_gn_iters_per_sec, 10 Gauss-Newton steps of 32 PCG iterations on
a 256-pose graph (BASELINE.json's "BA iters/sec"). A failure of either is
reported in the line (combined_error, pose_graph_error) instead of
dropping it. The line also names the card (`nvidia-smi` name and power
limit) and the host CPU.

Frames are generated once in worker processes and cached under the
temporary directory (tempfile.gettempdir()), keyed by their parameters.
Runs on the card unless --device cpu; a CPU run times PyTorch's CPU
kernels and names "cpu" as its device.

The roofline keys, bench.py's _roofline's counterpart: a counting pass
after the timed windows and the device_ms_per_frame chunks runs the first
window's frames once more, untimed, from a fresh engine state
(tools/work.count_frames) and reads each frame's live counts;
flops_per_frame and hbm_bytes_per_frame are the mean per frame of
tools/work.frame_work over them (operations summed over the frame's stages,
float32 and float64; the bytes the frame itself must read and write),
device_kind and power_limit_w the card's nvidia-smi name and limit
("cpu" and no limit on the CPU). On an H100 the line adds hbm_util =
hbm_bytes_per_frame x value / 3.35e12, flop_util = (float32 operations /
67e12 + float64 operations / 34e12) x value and roofline_bound, the larger
of the two ("bytes" or "operations"): the share of the card's roofline that
the measured frames/s reaches. A failure of the count goes into the line as
roofline_error.

The batch keys, scripts/bench_extras.py::bench_batch's counterpart (its
batch_loam_aggregate_frames_per_sec at pack12 false and true):
BatchLoamEngine(kitti_hdl64(), 4, chunk=8, quantize_mm=5.0) over that
script's 4 streams (batch_streams): stream b drives urban_scene(b,
extent=80) along drive_trajectory(80, speed=1.1, yaw_rate=0.01 + 0.002 b),
frame k seeded b * 1000 + k (the script's 32 frames are the first 32 of
these), 8 lockstep warm-up frames, each pushed stream by stream, then three
windows of 24 lockstep frames, each ended by a fresh
torch.cuda.synchronize(). batch_fps and batch_fps_median are the best and
the median window's aggregate frames/s (streams x lockstep frames / s) on
uint16 range images at 5 mm; batch_pack12_fps and batch_pack12_fps_median
the same on 3 cm images clipped at 4095 and staged as 12-bit pairs
(pack12=True: packed on the host, unpacked on the device). A failure of
either goes into the line as batch_error.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import platform
import subprocess
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

_CACHE_VERSION = 1  # bump when the synthetic world code changes


def _cache_path(key: str, params: tuple) -> Path:
    tag = hashlib.sha1(repr((_CACHE_VERSION,) + params).encode()).hexdigest()
    path = Path(tempfile.gettempdir()) / f"vloam_torch_bench_{key}_{tag[:12]}"
    return path.with_suffix(".npz")


def _cached(key: str, params: tuple, gen) -> list[np.ndarray]:
    """gen()'s arrays, cached in the temporary directory under a name that
    folds in every generation parameter."""
    path = _cache_path(key, params)
    try:
        with np.load(path) as z:
            return [z[k] for k in z.files]
    except (OSError, ValueError):
        arrs = gen()
        try:
            np.savez(path, *arrs)
        except OSError:
            pass
        return arrs


def _scan(args):
    """A polar scan of urban_scene(scene, extent=80) from pose T in
    range_scale-metre units."""
    from ..data import synthetic

    T, seed, n_scans, n_az, scene, range_scale = args
    return synthetic.simulate_scan_polar(
        synthetic.urban_scene(scene, extent=80.0), T, n_scans=n_scans,
        n_azimuth=n_az, noise=0.01, seed=seed, range_scale=range_scale)


def _image(args):
    from ..data import synthetic

    T, K, w, h = args
    img = synthetic.render_camera(synthetic.urban_scene(0, extent=80.0), T,
                                  K, w, h)
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def _pool_map(fn, items, workers: int) -> list:
    if workers <= 1:
        return [fn(x) for x in items]
    # spawned workers: the parent may already hold a CUDA context
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        return list(pool.map(fn, items))


PACK12_SCALE = 0.03  # bench_batch's pack12 range unit: 122.85 m in 12 bits


def batch_drives(batch: int, n_frames: int, n_scans: int, n_azimuth: int,
                 pack: bool, workers: int) -> list[list[np.ndarray]]:
    """scripts/bench_extras.py::bench_batch's streams, n_frames range images
    each: stream b drives urban_scene(b, extent=80) along
    drive_trajectory(n_frames, speed=1.1, yaw_rate=0.01 + 0.002 b), frame k
    seeded b * 1000 + k, in 5 mm units, or with pack in 3 cm units clipped
    at 4095. Cached a stream a mode; the streams not in the cache are made
    in one pool."""
    from ..data import synthetic

    scale = PACK12_SCALE if pack else 0.005
    poses = [synthetic.drive_trajectory(n_frames, speed=1.1,
                                        yaw_rate=0.01 + 0.002 * b)
             for b in range(batch)]
    keys = [(f"batch{b}_{n_frames}",
             (b, 80.0, n_scans, n_azimuth, 0.01, 1.1, 0.01 + 0.002 * b,
              scale, pack, n_frames)) for b in range(batch)]

    def make(bs) -> dict:
        if not bs:
            return {}
        scans = _pool_map(_scan, [(T, b * 1000 + k, n_scans, n_azimuth, b,
                                   scale)
                                  for b in bs for k, T in enumerate(poses[b])],
                          workers)
        if pack:
            scans = [np.minimum(s, 4095).astype(np.uint16) for s in scans]
        return {b: scans[i * n_frames:(i + 1) * n_frames]
                for i, b in enumerate(bs)}

    made = make([b for b in range(batch)
                 if not _cache_path(*keys[b]).exists()])
    return [_cached(*keys[b], lambda b=b: made.get(b) or make([b])[b])
            for b in range(batch)]


class _Calib:
    """The synthetic rig's calibration (bench.py's)."""

    def __init__(self, w: int, h: int):
        from ..data import synthetic

        self.K, P_rect0, _, velo_T_cam = synthetic.default_cam_calib(w, h)
        self.P_velo_to_img = P_rect0 @ np.linalg.inv(velo_T_cam)
        self.imu_T_velo = np.eye(4)
        self.imu_T_cam0 = velo_T_cam


def card_name(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    from .timing import card_line

    return card_line()


def roofline(w: dict, fps: float, card: str) -> dict:
    """The roofline keys of a frame's mean work w (tools/work.mean_work) at
    fps frames a second on the device `card` names (card_name's line): the
    utilisations only on an H100, whose peaks tools/timing.py holds."""
    from .timing import roofline as shares

    name, _, limit = card.partition(", ")
    out = {"flops_per_frame": w["ops"] + w["ops_f64"],
           "hbm_bytes_per_frame": w["bytes"], "device_kind": name}
    if limit:
        out["power_limit_w"] = float(limit.split()[0])
    if "H100" in name:
        r = shares(w["ops"], w["ops_f64"], w["bytes"], fps)
        out.update(hbm_util=r["hbm_util"], flop_util=r["flop_util"],
                   roofline_bound=r["roofline_bound"])
    return out


def frame_work(cfg, frames, device, warm: int) -> dict:
    """The mean work a frame of frames[warm:] (tools/work.mean_work), from a
    counting pass over all of frames from a fresh engine state."""
    from . import work

    counts = work.count_frames(cfg, frames, device)
    return work.mean_work([work.frame_work(cfg, c) for c in counts[warm:]])


def host_cpu() -> str:
    """The host CPU's model name (lscpu's, else /proc/cpuinfo's)."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=10).stdout
        for line in out.splitlines():
            if line.startswith("Model name:"):
                return line.split(":", 1)[1].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine()


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _windows(push, k0: int, window: int, windows: int,
             device) -> list[float]:
    """frames/s of `windows` windows of `window` calls push(k), k counting
    on from k0, each window ended by a fence."""
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for k in range(k0, k0 + window):
            push(k)
        _fence(device)
        rates.append(window / (time.perf_counter() - t0))
        k0 += window
    return rates


def bench_lidar(cfg, frames, device, chunk: int, warm: int, window: int,
                windows: int) -> dict:
    from ..lidar.loam_step import (LoamEngine, _upload_polar,
                                   loam_run_chunk_polar, unpack_outputs)

    eng = LoamEngine(cfg, chunk=chunk, device=device)
    for k in range(warm):
        eng.push_polar(frames[k])
    _fence(device)
    rates = _windows(lambda k: eng.push_polar(frames[k % len(frames)]),
                     warm, window, windows, device)
    t0 = time.perf_counter()
    _fence(device)
    fence_ms = (time.perf_counter() - t0) * 1e3
    outs = unpack_outputs(eng.finish())
    if not np.isfinite(outs["t_w_mo"]).all():
        raise RuntimeError("the engine's MO poses are not finite")

    # the chunk step alone, on range images already on the device
    n = min(4, len(frames) // chunk)
    chunks = [_upload_polar(np.stack(frames[i * chunk:(i + 1) * chunk]),
                            device) for i in range(n)]
    st = eng.state
    pq, pt, up = eng._priors(chunk)
    st, _ = loam_run_chunk_polar(st, chunks[0], eng._dirs, pq, pt, up, cfg,
                                 eng._polar_scale)
    _fence(device)
    t0 = time.perf_counter()
    for c in chunks[1:]:
        st, _ = loam_run_chunk_polar(st, c, eng._dirs, pq, pt, up, cfg,
                                     eng._polar_scale)
    _fence(device)
    device_ms = (time.perf_counter() - t0) / ((n - 1) * chunk) * 1e3

    # host-to-device copies of 4 MB (on the CPU: host copies)
    blob = torch.zeros((4 << 20,), dtype=torch.uint8)
    x = blob.to(device, copy=True)
    _fence(device)
    t0 = time.perf_counter()
    for _ in range(3):
        x = blob.to(device, copy=True)
    _fence(device)
    upload_mbps = 3 * blob.numel() / (time.perf_counter() - t0) / 1e6
    del x

    fps = max(rates)
    return {
        "metric": "loam_pipeline_frames_per_sec",
        "value": fps,
        "unit": "frames/s (fused scanreg+LO+MO, ~%dk pts/frame)" % (
            int(np.mean([(f > 0).sum() for f in frames])) // 1000),
        "vs_baseline": fps / 10.0,
        "value_median": sorted(rates)[len(rates) // 2],
        "window_rates": rates,
        "window_frames": window,
        "fence_ms": fence_ms,
        "device_ms_per_frame": device_ms,
        "upload_mbps": upload_mbps,
        "upload_ms_per_frame": max(0.0, 1000.0 / fps - device_ms),
    }


def bench_combined(cfg, frames, images, device, chunk: int, window: int,
                   windows: int) -> tuple[float, float]:
    """Best and median window frames/s of VloamEngine (detach_VO_LO=False)
    over the frames and images: `chunk` warm-up frames, then windows that
    cycle over the rest."""
    from ..lidar.loam_step import unpack_outputs
    from ..vloam_step import VloamEngine

    cfg_c = cfg.replace(detach_VO_LO=False)
    eng = VloamEngine(cfg_c, _Calib(cfg_c.vo.img_width, cfg_c.vo.img_height),
                      chunk=chunk, device=device)
    for k in range(chunk):
        eng.push_polar(frames[k], images[k])
    _fence(device)
    def push(k):  # cycles over the frames after the warm-up
        i = chunk + (k - chunk) % (len(images) - chunk)
        eng.push_polar(frames[i], images[i])

    rates = _windows(push, chunk, window, windows, device)
    if not np.isfinite(unpack_outputs(eng.finish())["t_w_mo"]).all():
        raise RuntimeError("the combined engine's MO poses are not finite")
    return max(rates), sorted(rates)[len(rates) // 2]


def bench_batch(cfg, streams, device, chunk: int = 8, window: int = 24,
                windows: int = 3, pack: bool = False) -> tuple[float, float]:
    """Best and median window aggregate frames/s (streams x lockstep frames
    a second) of BatchLoamEngine(cfg, len(streams), chunk, quantize_mm=5.0,
    pack12=pack) over the streams' range images (batch_drives): `chunk`
    lockstep warm-up frames, then `windows` windows of `window` lockstep
    frames, each frame pushed stream by stream (bench_extras.bench_batch).
    Raises unless finish() gives finite [B, F, 24] rows."""
    from ..lidar.loam_step import OUT_DIM, BatchLoamEngine

    if window % chunk:
        raise ValueError(f"window {window} is not a multiple of chunk "
                         f"{chunk}: a window would end inside a chunk")
    scale = PACK12_SCALE if pack else 0.005
    batch, n = len(streams), chunk + window * windows
    eng = BatchLoamEngine(cfg, batch, chunk=chunk, quantize_mm=5.0,
                          pack12=pack, device=device)

    def push(k):
        for b, frames in enumerate(streams):
            eng.push_polar(b, frames[k], range_scale=scale)

    for k in range(chunk):
        push(k)
    _fence(device)
    rates = [batch * r for r in _windows(push, chunk, window, windows,
                                         device)]
    outs = eng.finish()
    if outs.shape != (batch, n, OUT_DIM) or not np.isfinite(outs).all():
        raise RuntimeError(f"the batch engine's rows {outs.shape} are not "
                           f"{(batch, n, OUT_DIM)} finite rows")
    return max(rates), sorted(rates)[len(rates) // 2]


def bench_pose_graph(device, n_poses: int = 256, gn_iters: int = 10,
                     cg_iters: int = 32) -> float:
    """Gauss-Newton steps a second of optimize_pose_graph on a drifting
    n_poses chain closed by one loop (bench_extras.bench_pgo's graph)."""
    from scipy.spatial.transform import Rotation as R

    from ..parallel.pose_graph import build_odometry_graph, optimize_pose_graph

    poses = [np.concatenate([R.from_euler("z", 0.002 * k).as_quat(),
                             [0.5 * k, 0.001 * k * k, 0.0]])
             for k in range(n_poses)]
    g = build_odometry_graph(np.stack(poses), loop_pairs=[(n_poses - 1, 0)],
                             device=device)
    optimize_pose_graph(g, gn_iters=gn_iters, cg_iters=cg_iters)
    _fence(device)
    t0 = time.perf_counter()
    out = optimize_pose_graph(g, gn_iters=gn_iters, cg_iters=cg_iters)
    _fence(device)
    dt = time.perf_counter() - t0
    if not torch.isfinite(out).all():
        raise RuntimeError("the pose graph's poses are not finite")
    return gn_iters / dt


def run(device="cuda", cfg=None, n_azimuth: int = 1800, chunk: int = 16,
        warm: int = 16, window: int = 96, windows: int = 3,
        combined: tuple[int, int] = (8, 32),
        batch: tuple[int, int, int] = (4, 8, 24), n_poses: int = 256,
        workers: int | None = None, frames=None, images=None) -> dict:
    """The JSON record: bench.py's keys (the roofline keys as the module
    docstring says), the card, the host CPU, the combined engine's frames/s,
    the batch engine's aggregate frames/s at uint16 and pack12, and the pose
    graph's Gauss-Newton steps a second. The defaults are bench.py's and
    scripts/bench_extras.py's sizes; cfg defaults to kitti_hdl64().
    combined: (chunk and warm-up frames, window frames); batch: (streams,
    chunk and warm-up lockstep frames, window lockstep frames), `windows`
    windows each. frames, images: the drive's first warm + window range
    images and first sum(combined) camera images (uint8), where the caller
    has them already; otherwise they are generated (or read from the
    cache), as the batch streams always are."""
    from ..config import kitti_hdl64
    from ..data import synthetic
    from ..lidar.loam_step import engine_device

    cfg = cfg or kitti_hdl64()
    device = engine_device(device)
    workers = workers or max(1, min(8, os.cpu_count() or 1))
    n_frames = warm + window
    poses = synthetic.drive_trajectory(n_frames, speed=1.1, yaw_rate=0.01)
    n_scans = cfg.lidar.n_scans
    frames = frames or _cached(
        f"lidar_{n_frames}",
        (0, 80.0, n_scans, n_azimuth, 0.01, 1.1, 0.01, n_frames),
        lambda: _pool_map(_scan, [(T, k, n_scans, n_azimuth, 0, 0.005)
                                  for k, T in enumerate(poses)], workers))
    rec = {"device": card_name(device), "host_cpu": host_cpu()}
    rec.update(bench_lidar(cfg, frames, device, chunk, warm, window,
                           windows))
    try:  # after every timed window: the counting pass reads the device
        rec.update(roofline(frame_work(cfg, frames[:warm + window], device,
                                       warm), rec["value"], rec["device"]))
    except Exception as e:  # reported in the line, not dropped
        rec["roofline_error"] = repr(e)
    c_chunk, c_window = combined
    try:
        w, h = cfg.vo.img_width, cfg.vo.img_height
        calib = _Calib(w, h)
        n_img = c_chunk + c_window
        images = images or _cached(
            f"images_{n_img}", (0, 80.0, w, h, 1.1, 0.01, n_frames, n_img),
            lambda: _pool_map(_image, [(T @ calib.imu_T_cam0, calib.K, w, h)
                                       for T in poses[:n_img]], workers))
        best, median = bench_combined(cfg, frames, images, device, c_chunk,
                                      c_window, windows)
        rec.update(combined_fps=best, combined_vs_baseline=best / 6.8,
                   combined_fps_median=median)
    except Exception as e:  # reported in the line, not dropped
        rec["combined_error"] = repr(e)
    n_streams, b_chunk, b_window = batch
    rec["batch_streams"] = n_streams
    errors = []
    for pack, key in ((False, "batch_fps"), (True, "batch_pack12_fps")):
        try:
            streams = batch_drives(n_streams, b_chunk + b_window * windows,
                                   n_scans, n_azimuth, pack, workers)
            best, median = bench_batch(cfg, streams, device, b_chunk,
                                       b_window, windows, pack)
            rec.update({key: best, key + "_median": median})
        except Exception as e:  # reported in the line, not dropped
            errors.append(f"{key}: {e!r}")
    if errors:
        rec["batch_error"] = "; ".join(errors)
    try:
        rec["pose_graph_gn_iters_per_sec"] = bench_pose_graph(device,
                                                              n_poses)
    except Exception as e:
        rec["pose_graph_error"] = repr(e)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vloam_tpu_torch.tools.bench")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
