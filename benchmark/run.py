"""The port's benchmark: one cell of BENCHMARK.json, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (`setup_s`, from the start of this script): torch and the card, the
cell's drives made on the card from the seed, the engine, its kernel
library (built into vloam_tpu_torch/kernels/build/ at the first run of a
checkout) and one warm chunk through the same engine. The window then
pushes the drives' next frames closed-loop, whole chunks, until `--seconds`
have passed, and `finish()` downloads every row. With `--trace 0` the
whole window runs under torch.profiler's device activity alone:
`device_ms_per_frame` is the union of the intervals of all its kernel,
copy and fill records over the frames pushed in it (a frame a stream).
With `--trace 1` the same window runs unprofiled and is timed on the host
(`host_frames_per_s`, `enqueue_ms_per_frame`), then one more chunk runs
under torch.profiler (CPU and CUDA activities): launches, idle share and
the roofline share come from its records, written to
bench_out/<cell>.<seed>.trace.jsonl.gz.

After the window the device's peak memory is read, the engine is freed and
the plain reference follows the rows (benchmark/reference/check.py) at the
frames and streams drawn from the seed: `correct` is true when every number
compared lies within its limit in cells/<cell>.json. `attempted` counts
the frames pushed after the warm chunk (a frame a stream), `failed` those
whose row is missing or not finite and the checked frames with a gap past
its limit. The last line of
standard output is the result, as JSON; the numbers compared, each beside
its limit, are the last lines of standard error and the result's last key.

A run without a CUDA card, or with fewer cards than the cell asks for,
exits 2 and prints no result; so does one that finds JAX or the JAX package
loaded once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gzip  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every build and kernel cache inside the checkout, at fixed paths
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(ROOT / "bench_out" / "cache" / _sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "vloam_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: vloam_tpu_torch is not vloam_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card(device) -> dict:
    """The card's name and power limit (nvidia-smi's), on the CPU 'cpu'."""
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(smi.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(cell, seed: int, seconds: float, trace: bool, device="cuda",
            t_start: float | None = None,
            out_dir: Path | None = None) -> dict:
    """One run of `cell`: set-up, the window, the reference's check. The
    port and the reference each read the configuration file's "pipeline".
    Returns the result's fields and a `log` of lines for standard
    error."""
    import torch

    from benchmark import harness, trace as tr
    from benchmark.judge import Judge
    from benchmark.roofline import work

    t_start = time.perf_counter() if t_start is None else t_start
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = harness.port_config(cell.config["pipeline"])
    dev = torch.device(device)
    log = []
    t = time.perf_counter()
    drives = harness.make_drives(cell, seed, dev)
    _sync(dev)
    log.append(f"drives: {cell.streams} x {len(drives[0].ranges)} frames "
               f"made on {dev} in {time.perf_counter() - t:.3f} s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    feed = harness.Feed(cell, cfg, drives, dev)
    chunk, streams = cell.chunk, cell.streams
    for k in range(chunk):  # the warm chunk: every shape the window uses
        feed.push(k)
    feed.finish()
    setup_s = time.perf_counter() - t_start
    k0 = chunk
    feed.push_s = 0.0

    if not trace:
        from torch.profiler import ProfilerActivity, profile

        # the device's records of all the window's work; the profiler starts
        # before the window's clock and is read after it
        acts = [ProfilerActivity.CUDA if dev.type == "cuda"
                else ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            k1 = harness.run_window(feed.push, k0, chunk, seconds)
            rows = feed.finish()
            window_s = time.perf_counter() - t0
        t = time.perf_counter()
        spans = tr.device_intervals(prof)
        del prof
        busy_s = tr.union_ns(spans) / 1e9
        log.append(f"window: frames {k0}-{k1 - 1} x {streams} in "
                   f"{window_s:.3f} s under the profiler, device busy "
                   f"{busy_s:.6f} s over {len(spans)} device records, read in "
                   f"{time.perf_counter() - t:.3f} s")
        k_end = k1
    else:
        from torch.profiler import ProfilerActivity, profile

        t0 = time.perf_counter()
        k1 = harness.run_window(feed.push, k0, chunk, seconds)
        _sync(dev)
        host_window_s = time.perf_counter() - t0
        enqueue_s = feed.push_s
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            tp = time.perf_counter()
            for k in range(k1, k1 + chunk):
                feed.push(k)
            _sync(dev)
            prof_s = time.perf_counter() - tp
        k_end = k1 + chunk
        rows = feed.finish()
    ctx = None
    if trace:
        t = time.perf_counter()
        recs = tr.records(prof)
        del prof
        ctx = SimpleNamespace(
            recs=recs, frames_traced=chunk * streams, window_s=prof_s,
            busy_s=tr.busy_ns(recs) / 1e9, enqueue_s=enqueue_s,
            enqueue_frames=(k1 - k0) * streams, host_window_s=host_window_s,
            work=None)
        log.append(f"profiled frames {k1}-{k_end - 1}: {len(recs)} records "
                   f"read in {time.perf_counter() - t:.3f} s")
        if out_dir is not None:
            out_dir.mkdir(parents=True, exist_ok=True)
            path = out_dir / f"{cell.name}.{seed}.trace.jsonl.gz"
            with gzip.open(path, "wt", compresslevel=1) as f:
                for r in recs:
                    f.write(json.dumps(r) + "\n")
            log.append(f"trace: {path}")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del feed
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference's check ----
    t = time.perf_counter()
    n_rows = rows.shape[1]
    attempted = (k_end - k0) * streams
    finite = np.isfinite(rows).all(axis=2)
    failed = int((~finite[:, k0:]).sum()) + streams * max(0, k_end - n_rows)
    judge = Judge(cell, drives, seed, n_rows, dev)
    counted = (range(k1, k_end) if trace and judge.camera is None
               else range(0))
    values, over, counts = judge.readings(rows, counted)
    failed += over
    if counts:
        ctx.work = work.mean_work([work.frame_work(judge.cfg, c)
                                   for c in counts])
    limits = judge.limits
    checks = {name: {"value": values[name], "limit": limits[name]}
              for name in limits}
    correct = (failed == 0 and n_rows >= k_end
               and all(c["value"] <= c["limit"] for c in checks.values()))
    log.append(f"reference: frames {judge.frames[judge.streams[0]]} of "
               f"streams {judge.streams} checked, {n_rows} rows followed, "
               f"in {time.perf_counter() - t:.3f} s")

    metrics = {}
    if not trace:
        e2e = {"setup_s": setup_s}
        if busy_s > 0:
            e2e["device_ms_per_frame"] = busy_s * 1e3 / attempted
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = harness.load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = card(dev)
    device_info["memory_peak_bytes"] = int(peak)
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = ctx.busy_s
        device_info["window_s"] = ctx.window_s
        out["breakdown"] = {"device_ops": tr.top_device_ops(ctx.recs),
                            "idle_gaps": tr.idle_gaps(ctx.recs)}
    out["checks"] = checks
    out["log"] = log
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    res = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                  _T0, ROOT / "bench_out")
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)} (the benchmark "
              "runs the port without JAX)", file=sys.stderr)
        return 2
    for line in res.pop("log"):
        print(line, file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"{name} {c['value']:.6g} limit {c['limit']:.6g}",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
