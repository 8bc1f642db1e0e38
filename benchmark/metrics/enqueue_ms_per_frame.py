"""Host time inside the engine's push_polar calls a frame, in ms, over the
traced run's unprofiled window (the engine's enqueue: what a frame costs
the host before the device waits for it)."""


def read(ctx):
    if not ctx.enqueue_frames:
        return None
    return ctx.enqueue_s * 1e3 / ctx.enqueue_frames
