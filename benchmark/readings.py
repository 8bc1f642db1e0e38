"""The readings that a cell's limits are set from: the port's gaps from the
reference on many seeds, and the control's.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--control 1]

For each seed, in one process: the cell's set-up and a short window as
run.py makes them, then the reference follows the rows (float32) and the
port's numbers compared are its gaps from it. With --control 1 the control
follows the same rows too: the reference with every point cloud and image
held in bfloat16 (the precision below the configuration's float32), and
its numbers are its gaps from the float32 reference at the same frames. One
JSON line a seed. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def seed_readings(cell, seed: int, seconds: float, device,
                  control: bool) -> dict:
    """One seed's readings: {"program": {...}, "control": {...}}."""
    import torch

    from benchmark import harness
    from benchmark.judge import Judge
    from benchmark.reference import check

    cfg = harness.port_config(cell.config["pipeline"])
    drives = harness.make_drives(cell, seed, device)
    feed = harness.Feed(cell, cfg, drives, device)
    t = time.perf_counter()
    k = harness.run_window(feed.push, 0, cell.chunk, seconds)
    rows = feed.finish()
    fps = k * cell.streams / (time.perf_counter() - t)
    del feed
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    judge = Judge(cell, drives, seed, rows.shape[1], device)
    t = time.perf_counter()
    ref, _ = judge.reference(rows)
    ref_s = time.perf_counter() - t
    got = {b: {k: rows[b, k] for k in ref[b]} for b in ref}
    prog = {n: float(np.nanmax(v)) for n, v in judge.gaps(got, ref).items()}
    prog["world_chain_gap_m"] = judge.chain_gap(rows)
    out = {"seed": seed, "frames": int(k), "frames_per_s": fps,
           "reference_s": ref_s, "program": prog}
    if control:
        low, _ = judge.reference(rows, "bfloat16")
        ctl = {n: float(np.nanmax(v))
               for n, v in judge.gaps(low, ref).items()}
        ctl["world_chain_gap_m"] = max(
            float(np.max(check.pose_gap(w16[:, :4], w16[:, 4:], w32[:, :4],
                                        w32[:, 4:])))
            for w16, w32 in ((check.world_chain(rows[b], device, "bfloat16"),
                              check.world_chain(rows[b], device))
                             for b in range(rows.shape[0])))
        out["control"] = ctl
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    for s in args.seeds.split(","):
        rec = seed_readings(cell, int(s), args.seconds, "cuda",
                            bool(args.control))
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
