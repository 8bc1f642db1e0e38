"""The least time a frame's work needs on the card, as a share of the
device time a frame took in the profiled chunk: the larger of its
operations at the float32 and float64 rates and its bytes at the memory
rate (benchmark/roofline), over the union of the chunk's kernel, copy and
fill intervals a frame. The work is counted from the reference's pass over
the profiled frames (the LiDAR frame's stages only: a cell whose frames do
other work, such as VO, has none)."""

from benchmark.roofline import peaks


def read(ctx):
    if ctx.work is None or not ctx.frames_traced or ctx.busy_s <= 0:
        return None
    least_s = peaks.least_seconds(ctx.work["ops"], ctx.work["ops_f64"],
                                  ctx.work["bytes"])
    return 100.0 * least_s / (ctx.busy_s / ctx.frames_traced)
