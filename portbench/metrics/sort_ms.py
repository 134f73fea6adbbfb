"""Device ms a frame of the bounce sorts (``sortb{N}`` ranges): the key,
the argsort and the packed permutation. None on a frame that sorts
nothing (a scene under the sort's node gate)."""

import re

from portbench.harness.metrics import pass_ms


def read(ctx):
    return pass_ms(ctx, lambda t: re.fullmatch(r"sortb\d+", t) is not None)
