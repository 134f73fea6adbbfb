"""Host ms a frame in the ``sync`` spans inside ``Driver.step``: the copies
between host and device that wait for the device's queue to drain
(the camera matrices, the field of view, the NEE flag a bounce).
Read from stretches of frames with the program's recording on
(``harness/hostspans.py``)."""

from portbench.harness import hostspans


def read(ctx):
    return hostspans.reading(ctx, "sync_wait_ms")
