"""Device timing for the measurement entry points and chip_smoke.py.

A ctypes wrapper's host call takes ~30 us and most kernels here run shorter,
so a host clock, or a CUDA-event interval around one call, measures the
host. ``device_ms`` first queues a blocker (a few large matmuls) and, while
the card works on it, queues `runs` calls between two CUDA events: the host
is ahead of the device, the calls run back to back, and the interval over
`runs` is the device time one call adds to a busy stream (its kernels and
the gaps between them). With ``cold=True`` a buffer larger than the L2 cache
is copied before every call, as the thousands of kernels between two calls
on the main path overwrite the cache, and the copies' own time, taken
between two more events in the same queue, is subtracted. A plain PyTorch
version made of thousands of small kernels (K1's) outlasts the blocker: the
host cannot stay ahead, and its interval is what a caller waits.

torch.profiler's kernel durations are not used for this: on torch 2.11 /
CUDA 12.8 it lost records of short traces that followed large ones, at times
all of them.

``stage_clocks`` gives a stage of a frame (any call that queues work and
returns) its three clocks: the host's enqueue, the wall with a synchronize,
and the device time of its kernels replayed back to back from a CUDA graph;
with the kernel nodes of that graph and the hand-written kernels' launches
(the tools/profile_*stages.py tools).
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import time
import traceback
from pathlib import Path

import torch

from .. import kernels
from . import work

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA's H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores
H100_FP64_OPS_PER_S = 34e12  # float64 outside the tensor cores
# instruction issue: 132 SMs x 4 schedulers x 32 lanes, one warp instruction
# a scheduler a clock, at the H100 SXM's 1980 MHz maximum SM clock
H100_LANES = 132 * 4 * 32
H100_SM_HZ = 1.98e9
_L2_FLUSH_BYTES = 256 << 20  # 5x the H100's 50 MB L2
# the blocker: float32 products of [8192, 8192], ~20 ms each on an H100
_BLOCKER_N = 8192
_BLOCKER_MATMULS = 4


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("this measurement needs a GPU: "
                           "torch.cuda.is_available() is false")
    return torch.device("cuda")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def device_ms(fn, runs: int = 20, cold: bool = True,
              blockers: int = _BLOCKER_MATMULS) -> float:
    """Mean device time of one fn() in ms over `runs` calls queued behind a
    blocker of `blockers` large matmuls, with the L2 cache flushed before
    each call when `cold` (see the module docstring). fn must not wait for
    the device."""
    dev = require_cuda()
    for _ in range(3):
        fn()
    blocker = torch.ones((_BLOCKER_N, _BLOCKER_N), device=dev)
    if cold:
        src = torch.empty(_L2_FLUSH_BYTES // 4, device=dev)
        dst = torch.empty_like(src)
    e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    torch.cuda.synchronize()
    for _ in range(blockers):
        torch.mm(blocker, blocker)
    e0.record()
    if cold:
        for _ in range(runs):
            dst.copy_(src)
    e1.record()
    for _ in range(runs):
        if cold:
            dst.copy_(src)
        fn()
    e2.record()
    torch.cuda.synchronize()
    ms = (e1.elapsed_time(e2) - e0.elapsed_time(e1)) / runs
    if not ms > 0:
        raise RuntimeError(f"device_ms: measured {ms} ms per call")
    return ms


def capture(fn, keep_graph: bool = False) -> torch.cuda.CUDAGraph:
    """fn captured once into a CUDA graph (after a warm-up call on a side
    stream, as torch.cuda.graph wants). keep_graph: keep the captured
    cudaGraph_t readable (raw_cuda_graph); the graph is then instantiated at
    its first replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
    with torch.cuda.graph(graph):
        fn()
    return graph


def graphed(fn):
    """fn captured once into a CUDA graph; returns its replay. A composition
    of hundreds of small kernels outlasts device_ms's blocker (the host
    cannot queue them as fast as the card runs them); its replay runs them
    back to back, so device_ms of the replay is their device time."""
    return capture(fn).replay


@functools.cache
def _graph_api():
    """(cudaGraphGetNodes, cudaGraphNodeGetType, the library's name) from
    the libcudart this process loaded (torch's); OSError where it loaded
    none."""
    with open("/proc/self/maps") as maps:
        path = next((line.split()[-1] for line in maps
                     if "libcudart.so" in line), None)
    if path is None:
        raise OSError("no libcudart in this process")
    lib = ctypes.CDLL(path)
    get_nodes, node_type = lib.cudaGraphGetNodes, lib.cudaGraphNodeGetType
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                          ctypes.POINTER(ctypes.c_size_t)]
    node_type.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    get_nodes.restype = node_type.restype = ctypes.c_int
    return get_nodes, node_type, Path(path).name


def graph_kernel_nodes(graph: torch.cuda.CUDAGraph) -> tuple[int, str]:
    """The kernel nodes (cudaGraphNodeTypeKernel, 0) of a graph captured
    with keep_graph=True, and how they were counted."""
    raw = graph.raw_cuda_graph()
    get_nodes, node_type, lib = _graph_api()
    n = ctypes.c_size_t(0)
    if get_nodes(raw, None, ctypes.byref(n)):
        raise RuntimeError("cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if get_nodes(raw, nodes, ctypes.byref(n)):
        raise RuntimeError("cudaGraphGetNodes failed")
    kind = ctypes.c_int(-1)
    count = 0
    for node in nodes:
        if node_type(node, ctypes.byref(kind)):
            raise RuntimeError("cudaGraphNodeGetType failed")
        count += kind.value == 0
    return count, f"kernel nodes of the graph ({lib})"


def _failed_op(e: BaseException) -> str:
    """Where an exception left the port: the innermost frame of its
    traceback inside vloam_tpu_torch, as file:line and its source."""
    root = Path(__file__).resolve().parents[1]
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if Path(f.filename).resolve().is_relative_to(root)]
    if not frames:
        return "?"
    f = frames[-1]
    return (f"{Path(f.filename).resolve().relative_to(root.parent)}:"
            f"{f.lineno} {(f.line or '').strip()}")


def profiler_launches(fn) -> int:
    """The kernel launches one fn() makes, counted by torch.profiler (the
    runtime's and the driver's launch calls)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key.startswith(
        ("cudaLaunchKernel", "cuLaunchKernel")))


def stage_clocks(fn, runs: int = 3, device="cuda", replays: int = 20,
                 warm: bool = True) -> dict:
    """The clocks of one stage fn() (a call that queues work and returns):

    host_ms: the enqueue on the host clock, the queue empty before the call
    (a synchronize) and no synchronize inside it; wall_ms: the same call
    and a synchronize after it; both means over `runs` calls, after one
    warm-up call unless warm is False (the caller made it).
    device_ms: device_ms (warm L2, `replays` calls) of fn captured into a
    CUDA graph: its kernels replayed back to back, the host out of the way
    (device_how "graph replay"; one blocker matmul: a replay is queued in
    microseconds). A stage that cannot be captured keeps its
    capture error in capture_error and is timed queued, device_ms(fn)
    (device_how "queued": where the host cannot keep ahead, that is the
    host's time); capture_error names the op that stopped the capture (its
    file:line in the port and its source) and the error.
    launches: the kernel nodes of the captured graph (launches_how says
    so), or where no graph could be read, torch.profiler's count of one
    call's launches.
    hand: each hand-written kernel's launches in one call, from the
    wrappers' counts (kernels.LAUNCHES), kernels with none left out.
    On the CPU only host_ms and wall_ms; the rest are None."""
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if warm:
        fn()
    host = wall = 0.0
    hand = None
    for r in range(runs):
        sync()
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        host += t1 - t0
        wall += t2 - t0
        if r == 0:
            hand = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                    if v != before[k]}
    out = {"host_ms": host / runs * 1e3, "wall_ms": wall / runs * 1e3,
           "device_ms": None, "device_how": None, "launches": None,
           "launches_how": None, "hand": None, "capture_error": None}
    if not on_card:
        return out
    out["hand"] = hand
    try:
        graph = capture(fn, keep_graph=True)
    except RuntimeError as e:
        torch.cuda.synchronize()
        out.update(capture_error=f"{_failed_op(e)}: {type(e).__name__}: "
                   + str(e).strip().splitlines()[0],
                   device_ms=device_ms(fn, replays, cold=False),
                   device_how="queued", launches=profiler_launches(fn),
                   launches_how="torch.profiler (no graph)")
        return out
    try:
        out["launches"], out["launches_how"] = graph_kernel_nodes(graph)
    except (RuntimeError, OSError) as e:
        out["launches"] = profiler_launches(fn)
        out["launches_how"] = (f"torch.profiler (graph nodes unread: "
                               f"{type(e).__name__})")
    out["device_ms"] = device_ms(graph.replay, replays, cold=False,
                                 blockers=1)
    out["device_how"] = "graph replay"
    return out


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time an H100 could take: the larger of bytes over its
    memory rate and operations over its float32 rate, and which of the two
    it is."""
    by_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    by_ops = n_ops / H100_FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def select_rings_bound(n_points: int, n_rings: int,
                       scanreg) -> tuple[float, str]:
    """work.select_rings: K1 over n_points ring slots of n_rings rings."""
    return _bound(work.select_rings(n_points, n_rings, scanreg))


def row_gather_bound(n_rows: int, width: int,
                     n_unique: int) -> tuple[float, str]:
    """work.row_gather's bytes: each distinct row read once, each output row
    and index once."""
    return _bound(work.row_gather(n_rows, width, n_unique))


def grid_probe_bound(jobs) -> tuple[float, str]:
    """work.grid_probe's bytes and hashes, jobs of (Q queries, bucket
    capacity cap, distinct bucket rows probed)."""
    return _bound(work.grid_probe(jobs))


def ring_reduce_bound(Q: int, S: int, C: int, n_out: int) -> tuple[float, str]:
    """work.ring_reduce over every (ring, query, slot) pair: n_out [S, Q]
    4-byte outputs."""
    return _bound(work.ring_reduce(Q, S, C, n_out))


def zncc_bound(K: int, p: int, H: int, W: int) -> tuple[float, str]:
    """work.zncc: K3's image, keypoints and descriptors once, 5 operations
    a descriptor element."""
    return _bound(work.zncc(K, p, H, W))


def knn_bound(Q: int, C: int, k: int,
              live: int | None = None) -> tuple[float, str]:
    """work.knn: lidar/knn.masked_knn of Q queries against C candidates,
    every pair, or the Q x live pairs of the live candidates only."""
    return _bound(work.knn(Q, C, k, None if live is None else Q * live))


def _bound(ops_bytes: tuple[int, int]) -> tuple[float, str]:
    """bound_ms of work.py's (operations, bytes)."""
    return bound_ms(ops_bytes[1], ops_bytes[0])


def roofline(ops: float, ops_f64: float, n_bytes: float,
             fps: float) -> dict:
    """A frame's roofline on an H100 at fps frames a second: hbm_util, the
    bytes' share of the memory rate; flop_util, the float32 operations'
    share of the float32 rate plus the float64 operations' of the float64
    rate; roofline_bound, the larger of the two ("bytes" or "operations");
    bound_ms, the least time a frame could take (the larger share's time)."""
    hbm = n_bytes * fps / H100_BYTES_PER_S
    flop = (ops / H100_FP32_OPS_PER_S + ops_f64 / H100_FP64_OPS_PER_S) * fps
    return {"hbm_util": hbm, "flop_util": flop,
            "roofline_bound": "bytes" if hbm >= flop else "operations",
            "bound_ms": max(hbm, flop) / fps * 1e3}


def knn_issue_floor(Q: int, C: int, per_pair: float,
                    live: int | None = None) -> float:
    """kernels/csrc/knn.cu's issue floor in ms: the least time an H100
    takes to issue per_pair instructions (its main loop's, as
    kernels.build.knn_sass counts the machine code) for each of Q x C
    (query, slot) pairs, or of the Q x live pairs of the live candidates
    only, every scheduler issuing every clock at the maximum SM clock."""
    pairs = Q * (C if live is None else live)
    return pairs * per_pair / (H100_LANES * H100_SM_HZ) * 1e3
