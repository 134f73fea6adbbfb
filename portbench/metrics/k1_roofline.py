"""Kernel K1's share of its bound, in %: the least time one frame's K1
work needs by bytes (``harness/k1.py``, counted from the frame's
definition, over the card's published HBM bandwidth) over K1's device
time a frame in the trace of CUDA activity alone (kernels named
``wide_traverse_kernel``). None where K1 did not run."""

from portbench.harness import k1


def read(ctx):
    ms = sum(v for name, v in ctx.device.get("by_name", {}).items()
             if "wide_traverse_kernel" in name)
    if ctx.device_frames <= 0 or ms <= 0:
        return None
    w, h = ctx.size
    need = k1.frame_bytes(w * h * ctx.spp, ctx.bounces, ctx.probe,
                          ctx.triangles)
    bound_s = need / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * bound_s / (ms / 1e3 / ctx.device_frames)
