"""Host ms a frame in the ``shade{N}`` spans less their ``shadow``
children: the host's time issuing ``ops.shade``'s math.
Read from stretches of frames with the program's recording on
(``harness/hostspans.py``)."""

from portbench.harness import hostspans


def read(ctx):
    return hostspans.reading(ctx, "shade_host_ms")
