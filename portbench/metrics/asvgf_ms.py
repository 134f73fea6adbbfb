"""Device ms a frame of the A-SVGF denoiser (the ``asvgf`` range)."""

from portbench.harness.metrics import pass_ms


def read(ctx):
    return pass_ms(ctx, lambda t: t == "asvgf")
