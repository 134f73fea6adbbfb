"""Share of the device's idle time in which the host was inside a pass
span (``raygen``, ``sortb{N}``, ``intersect{N}``, ``gbuffer``,
``shade{N}``, ``shadow``, ``asvgf``), in %: each idle interval of the
trace of CUDA activity alone split by the innermost span open on the
host, on one clock.
Read from stretches of frames with the program's recording on
(``harness/hostspans.py``)."""

from portbench.harness import hostspans


def read(ctx):
    return hostspans.reading(ctx, "idle_in_passes")
