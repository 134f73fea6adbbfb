"""Host ms a frame in ``Driver.step`` (its ``step`` span): the camera, the
frame's passes issued, and every wait inside them.
Read from stretches of frames with the program's recording on
(``harness/hostspans.py``)."""

from portbench.harness import hostspans


def read(ctx):
    return hostspans.reading(ctx, "step_host_ms")
