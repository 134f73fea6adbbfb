"""Device kernels a frame in the trace of CUDA activity alone (copies and
fills not counted): the launches the host issues."""


def read(ctx):
    if ctx.device_frames <= 0 or ctx.device.get("kernels", 0) == 0:
        return None
    return ctx.device["kernels"] / ctx.device_frames
