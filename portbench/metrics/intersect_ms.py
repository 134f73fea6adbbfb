"""Device ms a frame of the closest-hit waves (``intersect{N}`` ranges):
the traversal kernel and ``recompute_uv``."""

import re

from portbench.harness.metrics import pass_ms


def read(ctx):
    return pass_ms(ctx, lambda t: re.fullmatch(r"intersect\d+", t)
                   is not None)
