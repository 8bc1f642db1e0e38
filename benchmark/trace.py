"""A profiled stretch's records, as torch.profiler recorded them.

The records are read raw (`kineto_results.events()`), without the
profiler's post-processing into an event tree (`key_averages()`), which
takes seconds a chunk of an engine's frames. Each record is (name, on the
device, start ns, duration ns). From them:
- the device's busy time: the union of the intervals of its kernel, memcpy
  and memset records, so overlapping work counts once;
- the host's launch calls: the CUDA API calls that queue a kernel, a
  graph, a copy or a fill;
- the breakdown: the device operations by total time, and the device's
  idle gaps by the host operation that was running through them.
"""

from __future__ import annotations

from typing import NamedTuple

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                "cuGraphLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset",
                "cuMemset", "cudaLaunchCooperativeKernel")
RUNTIME_PREFIXES = ("cuda", "cu")


class Record(NamedTuple):
    name: str
    device: bool
    start_ns: int
    dur_ns: int


def records(prof) -> list[Record]:
    """A finished profiler's records, hidden records left out."""
    from torch.autograd import DeviceType

    return [Record(e.name(), e.device_type() == DeviceType.CUDA,
                   int(e.start_ns()), int(e.duration_ns()))
            for e in prof.profiler.kineto_results.events()
            if not getattr(e, "is_hidden_event", lambda: False)()]


def device_intervals(prof) -> list[tuple[int, int]]:
    """A finished profiler's device records (kernels, copies, fills) as
    [start, end) ns intervals: the host's records are skipped unread, so
    a whole window's records read in seconds."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == cuda
                and not getattr(e, "is_hidden_event", lambda: False)()):
            s = int(e.start_ns())
            out.append((s, s + int(e.duration_ns())))
    return out


def union_ns(intervals) -> int:
    """The length of the union of [start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


def merged(intervals) -> list[tuple[int, int]]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(recs) -> int:
    """The device's busy time: the union of its records' intervals."""
    return union_ns((r.start_ns, r.start_ns + r.dur_ns)
                    for r in recs if r.device)


def launch_calls(recs) -> int:
    """Host calls that queue device work: kernel and graph launches, copies
    and fills."""
    return sum(1 for r in recs
               if not r.device and r.name.startswith(LAUNCH_CALLS))


def top_device_ops(recs, n: int = 10) -> list[list]:
    """[[name, seconds]] of the n device operations with the most time."""
    tot: dict[str, int] = {}
    for r in recs:
        if r.device:
            tot[r.name] = tot.get(r.name, 0) + r.dur_ns
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], ns / 1e9] for name, ns in top]


def idle_gaps(recs, n: int = 10) -> list[list]:
    """[[host activity, seconds]]: the device's idle gaps between its first
    and last record, each named by the innermost host operation (not a
    runtime call) running at the gap's middle, summed by name; the n with
    the most time."""
    busy = merged((r.start_ns, r.start_ns + r.dur_ns)
                  for r in recs if r.device)
    host = sorted((r.start_ns, r.start_ns + r.dur_ns, r.name) for r in recs
                  if not r.device and not r.name.startswith(RUNTIME_PREFIXES))
    tot: dict[str, int] = {}
    stack: list[tuple] = []  # ops started by the current middle, by start
    j = 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) // 2
        while j < len(host) and host[j][0] <= mid:
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()  # the latest-started op still running is innermost
        name = stack[-1][2] if stack else "host: no operator recorded"
        tot[name] = tot.get(name, 0) + (s1 - e0)
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], ns / 1e9] for name, ns in top]
