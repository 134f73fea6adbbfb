"""Host ms a frame in the ``asvgf`` span: the host's time issuing
A-SVGF's launches. None where A-SVGF did not run.
Read from stretches of frames with the program's recording on
(``harness/hostspans.py``)."""

from portbench.harness import hostspans


def read(ctx):
    return hostspans.reading(ctx, "asvgf_host_ms")
