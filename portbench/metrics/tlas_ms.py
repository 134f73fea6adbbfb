"""Device ms a frame of the two-level scene's instance loop itself (the
``tlas`` range, innermost): the rays taken to object space, the box
culls, the candidate selection and its sort, the gathers and scatters
and the winners' u, v, with the BLAS traversals (``blas``) apart. None
where the frame has no ``tlas`` span (a flattened scene)."""

from portbench.harness.metrics import range_ms


def read(ctx):
    return range_ms(ctx, "tlas")
