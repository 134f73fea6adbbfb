"""Device ms a frame of the shading passes (``shade{N}`` ranges), without
their shadow waves (``shade{N}/shadow``): ``ops.shade``'s math."""

import re

from portbench.harness.metrics import pass_ms


def read(ctx):
    return pass_ms(ctx, lambda t: re.fullmatch(r"shade\d+", t) is not None)
