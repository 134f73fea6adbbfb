"""Host ms a frame in ``Renderer.blit`` (its ``blit`` span): the tone map,
the resize, the read-back and its wait for the device.
Read from stretches of frames with the program's recording on
(``harness/hostspans.py``)."""

from portbench.harness import hostspans


def read(ctx):
    return hostspans.reading(ctx, "blit_ms")
