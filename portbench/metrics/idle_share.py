"""Share of the traced frames' wall time in which the device ran no
kernel, copy or fill, in %, from the trace of CUDA activity alone:
100 x (1 - busy / wall)."""


def read(ctx):
    if ctx.device_frames <= 0 or ctx.device_wall_s <= 0:
        return None
    busy_s = ctx.device.get("busy_ms", 0.0) / 1e3
    if busy_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / ctx.device_wall_s)
