"""Four ways of staging the polar chunk's upload, timed end to end (port of
scripts/profile_upload_overlap.py).

    python -m vloam_tpu_torch.tools.profile_upload_overlap [--device cpu]
        [--tiny] [--chunk F] [--chunks N] [--turns N]

  A  stack on the host, one upload a chunk at flush (what LoamEngine does:
     lidar/loam_step.py's _upload_polar, pinned memory, a non_blocking copy
     on the current stream)
  B  one upload a frame at push, stacked on the device at dispatch
  C  A with pack12 (12-bit packed: 25 % fewer bytes)
  D  B with pack12

The script's drive: urban_scene(0, extent=80) along drive_trajectory(F x
(N + 1), speed=1.1, yaw_rate=0.01), range images at 3 cm clipped at 4095
(pack12's range), frame k seeded k, through loam_run_chunk_polar at
kitti_hdl64() (or, --tiny, the tests' 16 x 360 profile). Each mode runs a
warm chunk, then N timed chunks, staging the next chunk while the current
one is queued, as the script does; modes alternate A, B, C, D for --turns
turns. For each: frames/s end to end, the host's enqueue ms a frame (until
the last chunk is queued) and, on the card, its copies' device ms a frame
(CUDA events around each upload's copy on the stream, after the host has
pinned it; a uint16 upload includes its widening to int32). All four modes
copy on the current stream (the engines' only stream; the JAX package has
no side stream either), so a frame's copy waits behind the previous
chunk's kernels: B can overlap the host's staging with the device's work,
never the copy itself. Every mode's
rows are checked bit for bit against A's (pack12 is exact below 4096). The
last line is JSON.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..lidar.loam_step import (LoamState, _polar_dirs, _upload_polar,
                               engine_device, loam_run_chunk_polar, pack12)
from .stages import profile, workers

MODES = ("A", "B", "C", "D")
RANGE_SCALE = 0.03
SCRIPT = "scripts/profile_upload_overlap.py"


def drive(n: int, n_scans: int, n_az: int, n_workers: int):
    """The script's range images [n_scans, n_az] uint16 at 3 cm, clipped at
    4095."""
    from ..data import synthetic
    from .bench import _cached, _pool_map, _scan

    poses = synthetic.drive_trajectory(n, speed=1.1, yaw_rate=0.01)
    frames = _cached(f"overlap_{n}", (0, 80.0, n_scans, n_az, 0.01, 1.1,
                                      0.01, RANGE_SCALE, n),
                     lambda: _pool_map(_scan, [(T, k, n_scans, n_az, 0,
                                                RANGE_SCALE)
                                               for k, T in enumerate(poses)],
                                       min(n, n_workers)))
    return [np.minimum(f, 4095).astype(np.uint16) for f in frames]


class _Copies:
    """Uploads as lidar/loam_step.py's _upload_polar makes them (pinned
    memory, a non_blocking copy on the current stream, a uint16 image
    widened to int32 on the device), with CUDA events around each one's
    device work: recorded after the host has pinned the array, so the
    interval is the copy (and the widening) on the stream, and not the
    host's staging while the stream waits. On the CPU nothing is
    recorded."""

    def __init__(self, device):
        self.on_card = device.type == "cuda"
        self.pairs = []

    def upload(self, arr: np.ndarray, device) -> torch.Tensor:
        if not self.on_card:
            return _upload_polar(arr, device)
        wide = arr.dtype == np.uint16
        host = torch.from_numpy(np.ascontiguousarray(
            arr.view(np.int16) if wide else arr)).pin_memory()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = host.to(device, non_blocking=True)
        if wide:
            out = out.to(torch.int32) & 0xFFFF
        end.record()
        self.pairs.append((start, end))
        return out

    def ms(self) -> float | None:
        if not self.on_card:
            return None
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def run_mode(mode: str, frames, cfg, device, chunk: int, n_chunks: int,
             dirs) -> dict:
    """One mode: a warm chunk, then n_chunks timed ones."""
    packed = mode in ("C", "D")
    per_frame = mode in ("B", "D")
    state = LoamState.create(cfg, device)
    pq = torch.zeros((chunk, 4), device=device)
    pq[:, 3] = 1.0
    pt = torch.zeros((chunk, 3), device=device)
    up = torch.zeros((chunk,), dtype=torch.bool, device=device)
    copies = _Copies(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def stage_chunk(i: int):
        fs = frames[i:i + chunk]
        if packed:
            fs = [pack12(f) for f in fs]
        if per_frame:
            return [copies.upload(f[None], device) for f in fs]
        return copies.upload(np.stack(fs), device)

    def dispatch(st, staged, outs):
        arr = torch.cat(staged) if isinstance(staged, list) else staged
        st, out = loam_run_chunk_polar(st, arr, dirs, pq, pt, up, cfg,
                                       RANGE_SCALE, packed=packed)
        outs.append(out)
        return st

    outs = []
    state = dispatch(state, stage_chunk(0), outs)  # warm chunk
    sync()
    copies.pairs.clear()
    t0 = time.perf_counter()
    staged = stage_chunk(chunk)
    for i in range(1, n_chunks):
        state = dispatch(state, staged, outs)
        staged = stage_chunk((i + 1) * chunk)  # the next while this runs
    state = dispatch(state, staged, outs)
    t_host = time.perf_counter() - t0
    sync()
    dt = time.perf_counter() - t0
    n = n_chunks * chunk
    copy_ms = copies.ms()
    return {"mode": mode, "fps": n / dt, "host_ms": t_host / n * 1e3,
            "wall_ms": dt / n * 1e3,
            "copy_ms": None if copy_ms is None else copy_ms / n,
            "copies": len(copies.pairs) if device.type == "cuda" else None,
            "rows": torch.cat(outs).cpu().numpy()}


def run(device="cuda", tiny: bool = False, chunk: int = 16,
        n_chunks: int = 4, turns: int = 2, frames=None) -> dict:
    """Every turn of the four modes; returns the JSON record (without the
    rows) and checks the rows. frames: the drive where the caller has it."""
    from .timing import card_line

    dev = engine_device(device)
    cfg, n_az = profile(tiny)
    S = cfg.lidar.n_scans
    card = card_line() if dev.type == "cuda" else "cpu"
    n = chunk * (n_chunks + 1)
    frames = frames if frames is not None else drive(n, S, n_az,
                                                     workers(tiny))
    dirs = _polar_dirs(cfg, n_az, None, dev)
    chunk_mb = chunk * S * n_az * 2 / 1e6
    print(f"[profile_upload_overlap] device {card}; "
          f"{'tiny_test_profile' if tiny else 'kitti_hdl64'} {S}x{n_az}, "
          f"chunk {chunk} ({chunk_mb:.2f} MB uint16, {chunk_mb * 0.75:.2f} "
          f"MB pack12), {n_chunks} timed chunks after a warm one; the port "
          f"of {SCRIPT}", flush=True)
    recs, ref = [], None
    for turn in range(turns):
        for mode in MODES:
            r = run_mode(mode, frames, cfg, dev, chunk, n_chunks, dirs)
            rows = r.pop("rows")
            if ref is None:
                ref = rows
            r["turn"] = turn
            r["rows_equal_A"] = bool(np.array_equal(
                rows.view(np.int32), ref.view(np.int32)))
            recs.append(r)
            copy = ("" if r["copy_ms"] is None else
                    f", copies {r['copy_ms']:.4f} ms a frame on the device "
                    f"({r['copies']} events)")
            print(f"mode {mode}: {r['fps']:7.2f} frames/s end to end, host "
                  f"enqueue {r['host_ms']:.2f} ms a frame, wall "
                  f"{r['wall_ms']:.2f}{copy}; rows "
                  f"{'identical to' if r['rows_equal_A'] else 'DIFFER from'}"
                  " A's", flush=True)
    return {"tool": "profile_upload_overlap", "device": card,
            "profile": "tiny_test_profile" if tiny else "kitti_hdl64",
            "chunk": chunk, "chunks": n_chunks, "turns": turns,
            "modes": recs,
            "rows_equal": all(r["rows_equal_A"] for r in recs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_upload_overlap",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--chunks", type=int, default=4,
                    help="timed chunks a mode (default 4)")
    ap.add_argument("--turns", type=int, default=2,
                    help="turns of A, B, C, D (default 2)")
    args = ap.parse_args(argv)
    rec = run(args.device, args.tiny, args.chunk, args.chunks, args.turns)
    print(json.dumps(rec), flush=True)
    return 0 if rec["rows_equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
