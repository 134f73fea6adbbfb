"""Host ms a frame in the ``tlas`` spans, with their ``blas`` traversals
and host reads inside: the host's time issuing a two-level scene's
instance loop. None where the program records no ``tlas`` span.
Read from stretches of frames with the program's recording on
(``harness/hostspans.py``)."""

from portbench.harness import hostspans


def read(ctx):
    return hostspans.reading(ctx, "span_ms:tlas")
