"""Frames a second on the host's clock: the frames pushed in the traced
run's unprofiled window (a frame a stream) over the time from its first
push until the device has finished them. Every frame is host-paced today,
so this is the host's speed: it spreads from run to run with the host."""


def read(ctx):
    if not ctx.enqueue_frames or ctx.host_window_s <= 0:
        return None
    return ctx.enqueue_frames / ctx.host_window_s
