"""BLAS traversals a frame of a two-level scene (the program's counter
``("blas", "k1" | "k2")``, one a traversal, summed over both kernels):
culled visits, candidate waves and drain waves. None where the program
counts none.
Read from stretches of frames with the program's recording on
(``harness/hostspans.py``)."""

from portbench.harness import hostspans


def read(ctx):
    return hostspans.reading(ctx, "count:blas")
