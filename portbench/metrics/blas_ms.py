"""Device ms a frame of the BLAS traversals of a two-level scene (the
``blas`` range: the dispatch's kernel, K1 or K2, on one BLAS). None where
the frame has no ``blas`` span (a flattened scene)."""

from portbench.harness.metrics import range_ms


def read(ctx):
    return range_ms(ctx, "blas")
