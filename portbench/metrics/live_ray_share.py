"""Live rays over ray slots, in %, over the frame's closest-hit
(``intersect{N}``) and shadow waves: the work a traversal launch does
against the slots it is launched over, counted by the program
(``spans.rays``).
Read from stretches of frames with the program's recording on
(``harness/hostspans.py``)."""

from portbench.harness import hostspans


def read(ctx):
    return hostspans.reading(ctx, "live_ray_share")
