"""The scan-to-map 5-NN at the JAX package's pipeline shapes (port of
scripts/bench_knn.py): lidar/knn.masked_knn, which on the card launches the
hand-written kernel kernels/csrc/knn.cu, beside its plain version.

    python -m vloam_tpu_torch.tools.bench_knn [--device cpu] [--scale N]
        [--runs N]

The script's four shapes (queries x candidates, k = 5): surf 16384 x 307200
and corner 4096 x 76800 (the mapping stage's stacks against a map of that
many slots), lo_flat 2048 x 32768 and lo_sharp 1024 x 8192 (LO's clouds).
Inputs as the script draws them: one numpy generator seeded 0, per shape
queries and candidates uniform in +-80 m, then each candidate live with
probability 0.7. --scale N divides both counts by N (the CPU tests).

For each shape: the kernel's time and the plain version's
(masked_knn_plain, in its tiles of 2048 x 8192 pairs: a materialised
surf distance matrix would take 20 GB; its peak allocation is printed), the
bound (tools/timing.knn_bound) over every pair and over the live pairs,
on the card the issue floor at the machine code's instructions a pair
(tools/timing.knn_issue_floor), and the kernel against the plain version
on the first 1024 queries, distance bits and indices. On the CPU both
columns run the plain version (CPU tensors take it) on the host clock.
The script's knn_pallas branch imports a module the JAX package does not
have; it has no counterpart and prints nothing. The last line is JSON.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..lidar.knn import masked_knn, masked_knn_plain
from .timing import card_line, device_ms, knn_bound, knn_issue_floor

SHAPES = (("surf", 16384, 307200), ("corner", 4096, 76800),
          ("lo_flat", 2048, 32768), ("lo_sharp", 1024, 8192))
K = 5
CHECK_ROWS = 1024  # queries checked bit for bit against the plain version


def inputs(shapes=SHAPES, scale: int = 1):
    """(name, Q, C, queries [Q, 3], cands [C, 3], mask [C]) for each shape,
    drawn in the script's order from one generator seeded 0."""
    rng = np.random.default_rng(0)
    for name, Q, C in shapes:
        Q, C = max(1, Q // scale), max(1, C // scale)
        q = rng.uniform(-80, 80, (Q, 3)).astype(np.float32)
        c = rng.uniform(-80, 80, (C, 3)).astype(np.float32)
        m = rng.uniform(size=C) < 0.7
        yield name, Q, C, q, c, m


def _host_ms(fn, runs: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    return (time.perf_counter() - t0) / runs * 1e3


def run(device="cuda", scale: int = 1, runs: int = 20,
        plain_runs: int = 3, per_pair: float | None = None) -> list[dict]:
    """Time and check every shape; returns a record a shape. With per_pair
    (the slice kernel's main-loop instructions a pair, kernels.build.
    knn_sass) the records carry the issue floors too."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but "
                           "torch.cuda.is_available() is false; pass "
                           "--device cpu")
    on_card = dev.type == "cuda"
    recs = []
    for name, Q, C, q, c, m in inputs(SHAPES, scale):
        q, c, m = (torch.from_numpy(a).to(dev) for a in (q, c, m))
        n = min(CHECK_ROWS, Q)
        d_k, i_k = masked_knn(q, c, m, k=K)
        d_p, i_p = masked_knn_plain(q[:n], c, m, k=K)
        same = (torch.equal(i_k[:n], i_p) and torch.equal(
            d_k[:n].view(torch.int32), d_p.view(torch.int32)))
        del d_k, i_k, d_p, i_p
        if on_card:
            ms = device_ms(lambda: masked_knn(q, c, m, k=K), runs,
                           cold=False)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            plain = device_ms(lambda: masked_knn_plain(q, c, m, k=K),
                              plain_runs, cold=False)
            peak = torch.cuda.max_memory_allocated() - base
        else:
            ms = _host_ms(lambda: masked_knn(q, c, m, k=K), runs)
            plain = _host_ms(lambda: masked_knn_plain(q, c, m, k=K),
                             plain_runs)
            peak = None
        live = int(m.sum())
        bound, by = knn_bound(Q, C, K)
        bound_live, by_live = knn_bound(Q, C, K, live=live)
        rec = {"shape": name, "Q": Q, "C": C, "live": live, "k": K,
               "ms": ms, "plain_ms": plain, "bound_ms": bound,
               "bound_by": by, "bound_live_ms": bound_live,
               "bound_live_by": by_live, "checked_rows": n,
               "identical": same, "plain_peak_bytes": peak,
               "clock": "device" if on_card else "host"}
        if per_pair is not None:
            rec["issue_floor_ms"] = knn_issue_floor(Q, C, per_pair)
            rec["issue_floor_live_ms"] = knn_issue_floor(Q, C, per_pair,
                                                         live=live)
        recs.append(rec)
        print(f"{name} {Q}x{C} ({rec['live']} live): masked_knn k={K} "
              f"{ms:9.3f} ms ({'knn.cu' if on_card else 'plain, CPU'}), "
              f"plain version {plain:9.3f} ms"
              + (f" (peak {peak / 2**20:.0f} MiB: its tiles; a whole "
                 f"distance matrix {Q * C * 4 / 2**20:.0f} MiB)"
                 if peak is not None else "")
              + f", bound {bound * 1e3:.4g} us ({by}) over every slot, "
              f"{bound_live * 1e3:.4g} us ({by_live}) over the live pairs"
              + (f", issue floor {rec['issue_floor_ms'] * 1e3:.4g} / "
                 f"{rec['issue_floor_live_ms'] * 1e3:.4g} us"
                 if per_pair is not None else "")
              + f"; first {n} queries "
              f"{'identical' if same else 'DIFFER'} to the plain version",
              flush=True)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_knn",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=1,
                    help="divide queries and candidates by this (default 1)")
    ap.add_argument("--runs", type=int, default=20,
                    help="calls a kernel time (default 20)")
    ap.add_argument("--plain-runs", type=int, default=3,
                    help="calls a plain version's time (default 3)")
    args = ap.parse_args(argv)
    on_card = torch.device(args.device).type == "cuda"
    card = card_line() if on_card else "cpu"
    print(f"[bench_knn] device {card}", flush=True)
    per_pair = None
    if on_card:  # the machine code's count (cuobjdump beside nvcc)
        from ..kernels import build

        per_pair = build.knn_sass(build.sass(build.build()))[1][K]
    recs = run(args.device, args.scale, args.runs, args.plain_runs,
               per_pair)
    print(json.dumps({"tool": "bench_knn", "device": card, "shapes": recs}),
          flush=True)
    return 0 if all(r["identical"] for r in recs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
