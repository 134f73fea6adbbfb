"""Sync sites a frame: the copies between host and device that make the
host wait, counted by the program where each is made (``spans.sync``),
the image's read-back in ``blit`` included.
Read from stretches of frames with the program's recording on
(``harness/hostspans.py``)."""

from portbench.harness import hostspans


def read(ctx):
    return hostspans.reading(ctx, "host_syncs_per_frame")
