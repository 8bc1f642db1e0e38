"""Host calls that queue device work a frame (kernel, graph, copy and fill
launches) in the profiled stretch: a CUDA graph lowers this count while the
device's kernel records stay the same."""

from benchmark import trace


def read(ctx):
    if not ctx.frames_traced:
        return None
    return trace.launch_calls(ctx.recs) / ctx.frames_traced
